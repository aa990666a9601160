"""PyTorch port, Llama-4-Maverick: top-1 lookahead routing with one shared
expert on the Agile decode plane, against the reference on the CPU (smoke
size, the reference's weights bridged through numpy).

Gates:

* the MoE layer's prefill data plane (kernels 3 and 4's plain versions, the
  plan routed top-1 from the route source) and the decode plane (kernel 2's
  plain version over a top-1 DecodePlan), each plus the shared expert,
  within 1e-5 of the reference's ``moe_layer`` and ``moe_decode_ffn``; the
  shared expert alone within 1e-5 of the reference's;
* the served streams identical to the reference ``ServeReplica``'s at spec
  widths 1 and 4 (prefill and decode plane);
* the mesh-bound replica at (1, 1) and (1, 2) (gloo processes, spawned;
  each rank holds its expert slice and the whole shared expert) serves the
  streams of the single-host reference on every rank.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_cases import TOL, bridge, host_mesh, j_serve, patch_check_rep, reference_and_port_streams
from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from test_torch_expert_parallel import run_ranks

ARCH = "llama4-maverick-400b-a17b"
SLOTS, PROMPT, GEN, N_REQ = 2, 8, 6, 4


def _cfgs(**kw):
    kw = dict(decode_plane=True, **kw)
    return dataclasses.replace(j_smoke(ARCH), **kw), dataclasses.replace(t_smoke(ARCH), **kw)


def test_smoke_config_is_top1_with_a_shared_expert():
    _, cfg = _cfgs()
    assert cfg.top_k == 1 and cfg.num_shared_experts == 1 and cfg.num_experts == 8
    assert cfg.route_mode == "lookahead" and cfg.layer_kinds == ("moe", "moe")


def test_moe_layer_and_shared_expert_match_reference():
    from repro.core.plans import DecodePlan as JPlan
    from repro.models import moe as jmoe
    from repro_torch.core.control_plane import route_topk_decode
    from repro_torch.core.plans import DecodePlan
    from repro_torch.models import moe as tmoe

    jcfg, tcfg = _cfgs()
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, bridge(jp), "cpu")
    jl0 = jp["blocks"]["scan"]["b0"]["moe"]
    jl0 = jax.tree.map(lambda a: a[0], jl0)
    tl0 = tp["layers"][0]["moe"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    # the shared expert alone
    sh_t = tmoe._shared_experts(torch.from_numpy(x.reshape(14, -1)), tl0)
    sh_j = jmoe._shared_experts(jnp.asarray(x.reshape(14, -1)), jl0)
    np.testing.assert_allclose(sh_t.numpy(), np.asarray(sh_j), atol=TOL, rtol=TOL)
    # prefill: top-1 routed from the route source, plus the shared expert
    yt, _ = tmoe.moe_layer(torch.from_numpy(x), torch.from_numpy(src), tl0, tcfg)
    yj, _ = jmoe.moe_layer(jnp.asarray(x), jnp.asarray(src), jl0, jcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    # decode: a top-1 plan, plus the shared expert
    plan = route_topk_decode(torch.from_numpy(src.reshape(14, -1)), tl0["router"], 1)
    assert tuple(plan.expert_ids.shape) == (14, 1) and bool((plan.weights == 1.0).all())
    dt = tmoe.moe_decode_ffn(torch.from_numpy(x), DecodePlan(plan.expert_ids.reshape(2, 7, 1),
                                                             plan.weights.reshape(2, 7, 1)), tl0)
    jplan = JPlan(jnp.asarray(plan.expert_ids.numpy().reshape(2, 7, 1)),
                  jnp.asarray(plan.weights.numpy().reshape(2, 7, 1)))
    dj = jmoe.moe_decode_ffn(jnp.asarray(x), jplan, jl0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Tn", [1, 4])
def test_streams_match_reference_replica(Tn, monkeypatch):
    jcfg, tcfg = _cfgs(spec_tokens=Tn)
    want, got, rep = reference_and_port_streams(jcfg, tcfg, SLOTS, PROMPT, GEN, N_REQ, monkeypatch)
    assert got == want and all(len(t) == GEN + 1 for t in got.values())
    assert rep.prefills == N_REQ and rep.launches > 0


def _mesh_worker(rank: int, world: int, d: str) -> None:
    """One rank of the mesh-bound Llama-4 replica; writes its streams."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(1, world, "cpu")
        out = {}
        for Tn in (1, 4):
            cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=Tn)
            params = params_from_numpy(cfg, dict(np.load(d / f"weights{Tn}.npz")), "cpu", mesh)
            layer = params["layers"][0]["moe"]
            assert layer["w_gate"].shape[0] == cfg.num_experts // world
            assert layer["shared"]["w_gate"].shape == (cfg.d_model, cfg.d_ff_expert)
            rep = tserve.ServeReplica(cfg, SLOTS, PROMPT + GEN + Tn, params, drafter="ngram", mesh=mesh)
            res = tserve.serve_queue(rep, tserve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ))
            out[str(Tn)] = {str(rid): r.tokens for rid, r in res.items()}
        (d / f"streams{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


_REFERENCE: dict = {}


def _single_host_reference(Tn, monkeypatch):
    """The reference replica's streams at spec width Tn and its weights as
    checkpoint leaves, made once for both worlds."""
    from repro.launch.serve import ServeReplica as JReplica

    if Tn not in _REFERENCE:
        patch_check_rep(monkeypatch)
        jcfg, _ = _cfgs(spec_tokens=Tn)
        jp = JModel(jcfg).init(jax.random.PRNGKey(0))
        rep = JReplica(jcfg, host_mesh(), SLOTS, PROMPT + GEN + Tn, jp, drafter="ngram")
        streams = j_serve(rep, tserve.synthetic_requests(jcfg.vocab_size, PROMPT, GEN, N_REQ))
        _REFERENCE[Tn] = ({str(rid): t for rid, t in streams.items()}, bridge(jp))
    return _REFERENCE[Tn]


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_replica_streams_match_single_host_reference(world, tmp_path, monkeypatch):
    want = {}
    for Tn in (1, 4):
        want[str(Tn)], arrays = _single_host_reference(Tn, monkeypatch)
        np.savez(tmp_path / f"weights{Tn}.npz", **arrays)
    run_ranks(_mesh_worker, world, tmp_path)
    for rank in range(world):
        assert json.loads((tmp_path / f"streams{rank}.json").read_text()) == want, f"rank {rank}"
