"""PyTorch port, serving: ``ServeReplica`` against the JAX reference's
``ServeReplica`` on the same synthetic queue and the same (bridged) weights.

Gate: the per-request token streams are IDENTICAL — at spec width 1, and at
width 4 with the ngram and the repeat drafters (verify/rollback makes every
stream the model's greedy stream, whatever the drafter proposes).
"""
from __future__ import annotations

import dataclasses
import inspect
import json

import jax
import numpy as np
import pytest

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import ServeReplica as JReplica
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve

ARCH = "qwen3-moe-235b-a22b"
SLOTS, PROMPT, GEN, N_REQ = 2, 8, 6, 4


def _j_serve(rep, requests):
    """The reference fabric's admission loop, one replica."""
    queue, out = list(requests), {}
    while queue or rep.has_work():
        while queue and rep.free_slots():
            r = queue.pop(0)
            rep.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in rep.step():
            out[res.rid] = res.tokens
    return out


_J_STREAMS = {}


def _host_mesh():
    """A (1, 1) mesh with Auto axes: the reference's sharding constraints
    refer to its axes, which jax.make_mesh now makes Explicit by default."""
    from jax.sharding import AxisType

    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def _reference_streams(Tn, drafter):
    key = (Tn, drafter)
    if key not in _J_STREAMS:
        cfg = dataclasses.replace(j_smoke(ARCH), decode_plane=True, spec_tokens=Tn)
        params = JModel(cfg).init(jax.random.PRNGKey(0))
        reqs = tserve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ)
        rep = JReplica(cfg, _host_mesh(), SLOTS, PROMPT + GEN + Tn, params, drafter=drafter)
        names, leaves, _ = _flatten(params)
        _J_STREAMS[key] = (_j_serve(rep, reqs), {n: np.asarray(l) for n, l in zip(names, leaves)})
    return _J_STREAMS[key]


def _shard_map_accepting_check_rep(f, **kw):
    """The reference passes ``check_rep``, which this jax renamed ``check_vma``."""
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return jax.shard_map(f, **kw)


@pytest.mark.parametrize("Tn,drafter", [(1, "ngram"), (4, "ngram"), (4, "repeat")])
def test_serve_streams_match_reference(Tn, drafter, monkeypatch):
    import repro.parallel.moe_parallel as moe_parallel

    if "check_rep" not in inspect.signature(moe_parallel.shard_map).parameters:
        monkeypatch.setattr(moe_parallel, "shard_map", _shard_map_accepting_check_rep)
    want, arrays = _reference_streams(Tn, drafter)
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=Tn)
    params = params_from_numpy(cfg, arrays, "cpu")
    rep = tserve.ServeReplica(cfg, SLOTS, PROMPT + GEN + Tn, params, drafter=drafter, device="cpu")
    got = tserve.serve_queue(rep, tserve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ))
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert all(len(t) == GEN + 1 for t in want.values())
    assert rep.launches > 0 and rep.prefills == N_REQ


def test_synthetic_queue_is_the_reference_cli_queue():
    """Same seed, same draws as ``repro.launch.serve``'s queue: ragged
    prompts cycling through the three length buckets."""
    reqs = tserve.synthetic_requests(256, 16, 5, 6)
    rng = np.random.default_rng(0)
    rng.integers(0, 256, size=0)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.prompt, rng.integers(0, 256, size=[8, 12, 16][i % 3]))
        assert r.gen == 5


def test_rejects_request_over_the_slot_budget():
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=2)
    rep = tserve.ServeReplica(cfg, 1, 10, {}, device="cpu")
    res = tserve.serve_queue(rep, [tserve.Request(rid=3, prompt=np.zeros(8, np.int32), gen=4)])
    assert res[3].error is not None and res[3].tokens == []


def test_cli_dumps_one_stream_per_request(tmp_path, capsys):
    out = tmp_path / "tokens.json"
    code = tserve.main([
        "--arch", ARCH, "--smoke", "--decode-plane", "--spec-tokens", "2", "--slots", "2",
        "--prompt-len", "8", "--gen", "3", "--requests", "3", "--device", "cpu", "--dump-tokens", str(out),
    ])
    assert code == 0
    streams = json.loads(out.read_text())
    assert sorted(streams) == ["0", "1", "2"] and all(len(s) == 4 for s in streams.values())
    assert "served 3 requests" in capsys.readouterr().out
