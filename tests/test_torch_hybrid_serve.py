"""PyTorch port, hybrid serving: ``ServeReplica`` on the RecurrentGemma smoke
config (rolling-window caches and RG-LRU state) against the JAX reference's
``ServeReplica`` on the same synthetic queue and the same bridged weights.

Gate: identical per-request token streams, with 2 slots for 4 requests
(slots are reused, so admission must reset the RG-LRU state and the rolling
buffers) and prompts of 20/30/40 tokens, past the smoke window of 16.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import ServeReplica as JReplica
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve

ARCH = "recurrentgemma-2b"
SLOTS, PROMPT, GEN, N_REQ = 2, 40, 6, 4


def _host_mesh():
    """A (1, 1) mesh with Auto axes (the reference's sharding constraints
    name its axes; jax.make_mesh now makes them Explicit by default)."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def test_hybrid_serve_streams_match_reference():
    cfg_j = dataclasses.replace(j_smoke(ARCH), decode_plane=True)
    params = JModel(cfg_j).init(jax.random.PRNGKey(0))
    max_len = PROMPT + GEN + 1
    reqs = tserve.synthetic_requests(cfg_j.vocab_size, PROMPT, GEN, N_REQ)
    assert min(len(r.prompt) for r in reqs) > cfg_j.local_window
    rep_j = JReplica(cfg_j, _host_mesh(), SLOTS, max_len, params)
    queue, want = list(reqs), {}
    while queue or rep_j.has_work():
        while queue and rep_j.free_slots():
            r = queue.pop(0)
            rep_j.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in rep_j.step():
            want[res.rid] = res.tokens
    names, leaves, _ = _flatten(params)
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True)
    tparams = params_from_numpy(cfg, {n: np.asarray(l) for n, l in zip(names, leaves)}, "cpu")
    rep = tserve.ServeReplica(cfg, SLOTS, max_len, tparams, device="cpu")
    got = tserve.serve_queue(rep, reqs)
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert all(len(t) == GEN + 1 for t in want.values())
    assert rep.prefills == N_REQ and rep.launches > 0
    assert rep.cache[2]["k"].shape[1] == cfg.local_window  # the buffer is the window, not max_len


def test_hybrid_serve_refuses_multi_token_launches(capsys):
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=2)
    with pytest.raises(NotImplementedError, match="serve rec/ssm archs with spec_tokens=1"):
        tserve.ServeReplica(cfg, 1, 32, {}, device="cpu")
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--spec-tokens", "4", "--device", "cpu"])
    assert "multi-token decode for 'rec' layers" in capsys.readouterr().err


def test_hybrid_cli_serves_prompts_past_the_window(capsys):
    code = tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--slots", "2", "--prompt-len", "24",
                        "--gen", "3", "--requests", "3", "--device", "cpu"])
    assert code == 0
    assert "served 3 requests" in capsys.readouterr().out
