"""PyTorch port, Mamba-2 serving: ``ServeReplica`` on the mamba2-2.7b smoke
config (SSD state, no KV cache) against the JAX reference's
``ServeReplica`` on the same synthetic queue and the same bridged weights,
and the port's serve CLI on that arch.

Gate: identical per-request token streams, with 2 slots for 4 requests
(slots are reused, so admission must reset the SSD state and conv tail)
and prompts of 20/30/40 tokens, across the smoke chunk of 16 with ragged
tails.
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

ARCH = "mamba2-2.7b"
SLOTS, PROMPT, GEN, N_REQ = 2, 40, 6, 4


def _host_mesh():
    """A (1, 1) mesh with Auto axes (the reference's sharding constraints
    name its axes; jax.make_mesh now makes them Explicit by default)."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def test_ssm_serve_streams_match_reference():
    cfg_j = dataclasses.replace(j_smoke(ARCH), decode_plane=True)
    params = JModel(cfg_j).init(jax.random.PRNGKey(0))
    max_len = PROMPT + GEN + 1
    reqs = tserve.synthetic_requests(cfg_j.vocab_size, PROMPT, GEN, N_REQ)
    assert sorted({len(r.prompt) for r in reqs}) == [20, 30, 40]
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
    assert [sorted(c) for c in rep.cache] == [["conv", "h"]] * cfg.num_layers  # no KV rows


def test_ssm_serve_refuses_multi_token_launches_trees_and_pages(capsys):
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=2)
    with pytest.raises(NotImplementedError, match="serve rec/ssm archs with spec_tokens=1"):
        tserve.ServeReplica(cfg, 1, 32, {}, device="cpu")
    base = ["--arch", ARCH, "--smoke", "--decode-plane", "--device", "cpu"]
    # --paged serves (tests/test_torch_ssm_paged.py); a draft tree is a
    # multi-token launch, refused as the reference refuses it
    for extra, words in ((["--spec-tokens", "4"], "multi-token decode for 'ssm' layers"),
                         (["--paged", "--draft-tree", "2,1"], "multi-token decode for 'ssm' layers"),
                         (["--draft-tree", "2,1"], "serve rec/ssm archs with spec_tokens=1")):
        with pytest.raises(SystemExit) as exit_:
            tserve.main(base + extra)
        assert exit_.value.code == 2
        assert words in capsys.readouterr().err


def test_ssm_cli_serves_on_the_cpu(capsys):
    code = tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--slots", "2", "--prompt-len", "40",
                        "--gen", "4", "--requests", "3", "--device", "cpu"])
    assert code == 0
    assert "served 3 requests" in capsys.readouterr().out
