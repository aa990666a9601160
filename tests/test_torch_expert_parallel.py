"""PyTorch port, the expert-parallel MoE plane across ranks: gloo process
groups of 1, 2 and 4 CPU processes (spawned, rendezvous through a file under
the test's temporary directory; no group is ever made in the test process).

Gates, every rank against the JAX reference on the same numpy inputs:

* the a2a body (S = 16: the sequence splits over the ``model`` axis) equals
  the reference's route -> dispatch -> ``local_experts_fn`` -> combine
  applied chunk by chunk (each rank's chunk routed with the chunk's
  capacity, drops included at capacity factor 1.25), plus the shared
  expert; the aux losses their mean over chunks;
* the psum body (S = 15 at 2 and 4 ranks, S = 1) equals the same pipeline
  over the whole sequence;
* at one rank, both equal the reference's ``make_sharded_moe_apply`` on a
  1 x 1 mesh;
* the decode apply at T = 1 and 4 equals ``moe_decode/ref.decode_moe`` plus
  the shared expert;
* the mesh-bound model on bridged weights (prefill, then two
  ``decode_tokens`` launches, the second the rollback-shaped relaunch of
  ``tests/test_sharded_decode.py``) gives the reference single-host
  ``Model``'s greedy tokens exactly at spec widths 1 and 4.

Tolerance 1e-5 on every float (f32; the sides sum in different orders).
The reference's own multi-device tests do not run on this jax (ROADMAP
Queue C, R2/R3), so the port is held against its single-host outputs, which
its contract says the sharded ones must equal.
"""
from __future__ import annotations

import dataclasses
import functools
import multiprocessing as mp
import time
from pathlib import Path

import numpy as np
import pytest

ARCH = "qwen3-moe-235b-a22b"
TOL = 1e-5
WORLDS = [1, 2, 4]
B_MOE, SEQS, DEC_T = 2, (16, 15, 1), (1, 4)
B_MODEL, S_MODEL = 4, 16


def _moe_cfg(cfg):
    """Routing that is not vacuous (16 experts, top-2, drops at cf 1.25)
    and one shared expert."""
    return dataclasses.replace(cfg, num_experts=16, top_k=2, capacity_factor=1.25, num_shared_experts=1,
                               decode_plane=True)


def _model_cfg(cfg, Tn):
    return dataclasses.replace(cfg, decode_plane=True, spec_tokens=Tn)


# ---------------------------------------------------------------------------
# child processes: the port only (this module imports no jax at top level)
# ---------------------------------------------------------------------------


def _tree(flat, prefix):
    out: dict = {}
    for name, arr in flat.items():
        if not name.startswith(prefix):
            continue
        node = out
        parts = name[len(prefix):].split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    return out


def _port_outputs(world: int, d: Path) -> dict:
    import torch

    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.plans import DecodePlan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_model
    from repro_torch.parallel.moe_parallel import make_sharded_decode_apply, make_sharded_moe_apply
    from repro_torch.parallel.sharding import shard_params

    inp = dict(np.load(d / "inputs.npz"))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    mesh = make_host_mesh(1, world, "cpu")
    out = {}
    cfg = _moe_cfg(get_smoke_config(ARCH))
    full = {k: t(v) for k, v in inp.items() if k.startswith("moe/")}
    p = shard_params(_tree(full, "moe/"), cfg, mesh)
    apply = make_sharded_moe_apply(cfg, mesh, ("data",))
    for S in SEQS:
        y, aux = apply(t(inp[f"x{S}"]), t(inp[f"rs{S}"]), p)
        out[f"moe_y{S}"], out[f"moe_aux{S}"] = y.numpy(), aux.numpy()
    dec = make_sharded_decode_apply(cfg, mesh, ("data",))
    for T in DEC_T:
        plan = DecodePlan(t(inp[f"dec_ids{T}"]), t(inp[f"dec_w{T}"]))
        out[f"dec_y{T}"] = dec(t(inp[f"dec_x{T}"]), plan, p).numpy()
    for Tn in (1, 4):
        mcfg = _model_cfg(get_smoke_config(ARCH), Tn)
        arrays = {k[len(f"model{Tn}/"):]: v for k, v in inp.items() if k.startswith(f"model{Tn}/")}
        params = params_from_numpy(mcfg, arrays, "cpu", mesh)
        model = build_model(mcfg, mesh, B_MODEL)
        max_len = S_MODEL + 3 * Tn + 2
        cache = model.init_cache(B_MODEL, max_len)
        out[f"m{Tn}_prefill"] = model.prefill(params, inp["prompts"], cache).numpy()
        for i in range(2):
            out[f"m{Tn}_launch{i}"] = model.decode_tokens(
                params, cache, inp[f"m{Tn}_draft{i}"], inp[f"m{Tn}_lens{i}"], inp[f"m{Tn}_acc{i}"]).numpy()
    return out


def _worker(rank: int, world: int, d: str) -> None:
    import torch.distributed as dist

    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    try:
        np.savez(d / f"out{rank}.npz", **_port_outputs(world, d))
    finally:
        dist.destroy_process_group()


def run_ranks(target, world: int, d: Path, timeout: float = 120.0):
    """Run ``target(rank, world, d)`` in ``world`` spawned processes; kill
    them all and fail if any is still running after ``timeout`` seconds (a
    hung collective fails the test, not the suite)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, str(d))) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(5)
    assert not hung, f"{len(hung)} of {world} ranks still running after {timeout:.0f} s"
    assert [p.exitcode for p in procs] == [0] * world, f"rank exit codes {[p.exitcode for p in procs]}"


# ---------------------------------------------------------------------------
# the test process: inputs, the reference's outputs, the comparisons
# ---------------------------------------------------------------------------

_REF: dict = {}
_OUT: dict = {}


def _flatten_params(params, prefix):
    from repro.checkpoint.manager import _flatten

    names, leaves, _ = _flatten(params)
    return {prefix + n: np.asarray(v) for n, v in zip(names, leaves)}


def _reference(d: Path) -> dict:
    """Write the inputs for the ranks and compute the reference's outputs."""
    if _REF:
        return _REF
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.core.control_plane import capacity_for, combine, dispatch, route_topk
    from repro.kernels.moe_decode.ref import decode_moe
    from repro.models.model import Model
    from repro.models.moe import _shared_experts, init_moe, local_experts_fn

    rng = np.random.default_rng(0)
    inp, ref = {}, {}
    cfg = _moe_cfg(get_smoke_config(ARCH))
    p = init_moe(jax.random.PRNGKey(3), cfg)
    inp.update(_flatten_params(p, "moe/"))
    d_model, E, k = cfg.d_model, cfg.num_experts, cfg.top_k

    @functools.partial(jax.jit, static_argnums=3)
    def chunk(xc, rc, p, C):
        plan, aux = route_topk(rc, p["router"], k, C)
        y = combine(local_experts_fn(dispatch(xc, plan), p), plan) + _shared_experts(xc, p)
        return y, jnp.stack([aux.load_balance_loss, aux.router_z_loss])

    for S in SEQS:
        x = rng.standard_normal((B_MOE, S, d_model)).astype(np.float32)
        rs = rng.standard_normal((B_MOE, S, d_model)).astype(np.float32)
        inp[f"x{S}"], inp[f"rs{S}"] = x, rs
        for ep in WORLDS:
            # the a2a body splits the sequence over the ranks; the psum body
            # routes it whole
            chunks = ep if S % ep == 0 and S >= ep else 1
            Sc = S // chunks
            ys, auxes = [], []
            for m in range(chunks):
                xc = jnp.asarray(x[:, m * Sc:(m + 1) * Sc].reshape(-1, d_model))
                rc = jnp.asarray(rs[:, m * Sc:(m + 1) * Sc].reshape(-1, d_model))
                y, aux = chunk(xc, rc, p, capacity_for(B_MOE * Sc, E, k, cfg.capacity_factor))
                ys.append(np.asarray(y).reshape(B_MOE, Sc, d_model))
                auxes.append(np.asarray(aux))
            ref[f"moe_y{S}_{ep}"] = np.concatenate(ys, axis=1)
            ref[f"moe_aux{S}_{ep}"] = np.mean(np.asarray(auxes, np.float32), axis=0)
    for T in DEC_T:
        x = rng.standard_normal((3, T, d_model)).astype(np.float32)
        ids = np.stack([rng.permutation(E)[:k] for _ in range(3 * T)]).astype(np.int32).reshape(3, T, k)
        w = rng.random((3, T, k)).astype(np.float32)
        inp[f"dec_x{T}"], inp[f"dec_ids{T}"], inp[f"dec_w{T}"] = x, ids, w
        y = jax.jit(lambda xf, ids, w, p: decode_moe(xf, ids, w, p["w_gate"], p["w_up"], p["w_down"])
                    + _shared_experts(xf, p))(jnp.asarray(x.reshape(-1, d_model)), jnp.asarray(ids.reshape(-1, k)),
                                              jnp.asarray(w.reshape(-1, k)), p)
        ref[f"dec_y{T}"] = np.asarray(y).reshape(3, T, d_model)

    # the single-host model: prefill, one launch, the rollback-shaped relaunch
    mcfg0 = get_smoke_config(ARCH)
    prompts = rng.integers(0, mcfg0.vocab_size, (B_MODEL, S_MODEL)).astype(np.int32)
    inp["prompts"] = prompts
    for Tn in (1, 4):
        mcfg = _model_cfg(mcfg0, Tn)
        host = Model(mcfg)
        params = host.init(jax.random.PRNGKey(0))
        inp.update(_flatten_params(params, f"model{Tn}/"))
        cache = host.init_cache(B_MODEL, S_MODEL + 3 * Tn + 2)
        lg, cache = jax.jit(host.prefill)(params, jnp.asarray(prompts), cache)
        ref[f"m{Tn}_prefill"] = np.asarray(lg)
        t0 = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
        step = jax.jit(host.decode_tokens)
        draft = np.tile(t0[:, None], (1, Tn))
        lens, acc = np.full((B_MODEL,), S_MODEL, np.int32), np.zeros((B_MODEL,), np.int32)
        for i in range(2):
            inp[f"m{Tn}_draft{i}"], inp[f"m{Tn}_lens{i}"], inp[f"m{Tn}_acc{i}"] = draft, lens, acc
            lgx, cache = step(params, cache, jnp.asarray(draft), jnp.asarray(lens), jnp.asarray(acc))
            ref[f"m{Tn}_launch{i}"] = np.asarray(lgx)
            # one token accepted: row 0 selected, lengths + 1, the next draft
            # from the verified token
            draft = np.tile(np.argmax(ref[f"m{Tn}_launch{i}"], -1)[:, :1].astype(np.int32), (1, Tn))
            lens = lens + 1
    np.savez(d / "inputs.npz", **inp)
    _REF.update(ref)
    return _REF


@pytest.fixture(scope="module")
def ep_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("expert_parallel")


def _outputs(world: int, d: Path):
    """Every rank's port outputs at ``world`` ranks (one spawn per world)."""
    ref = _reference(d)
    if world not in _OUT:
        wd = d / f"world{world}"
        wd.mkdir()
        (wd / "inputs.npz").symlink_to(d / "inputs.npz")
        run_ranks(_worker, world, wd)
        _OUT[world] = [dict(np.load(wd / f"out{r}.npz")) for r in range(world)]
    return ref, _OUT[world]


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("S", SEQS)
def test_moe_apply_matches_reference_chunk_by_chunk(world, S, ep_dir):
    """a2a at S = 16 (and at one rank everywhere), psum at S = 15 over 2 or
    4 ranks and at S = 1: every rank's (B, S, d) output and aux losses."""
    ref, outs = _outputs(world, ep_dir)
    for out in outs:
        _close(out[f"moe_y{S}"], ref[f"moe_y{S}_{world}"])
        _close(out[f"moe_aux{S}"], ref[f"moe_aux{S}_{world}"])


def test_one_rank_matches_reference_sharded_apply(ep_dir, monkeypatch):
    """At one rank the port's apply equals the reference's
    ``make_sharded_moe_apply`` on a 1 x 1 mesh (Auto axes, and the
    ``check_rep`` keyword mapped to this jax's ``check_vma``: Queue C, R3)."""
    import inspect

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    import repro.parallel.moe_parallel as jmp
    from repro.configs import get_smoke_config

    if "check_rep" not in inspect.signature(jmp.shard_map).parameters:
        def shim(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return jax.shard_map(f, **kw)

        monkeypatch.setattr(jmp, "shard_map", shim)
    ref, outs = _outputs(1, ep_dir)
    inp = dict(np.load(ep_dir / "inputs.npz"))
    p = {}
    for name, arr in inp.items():
        if name.startswith("moe/"):
            node = p
            parts = name[4:].split("/")
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = jnp.asarray(arr)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    apply = jax.jit(jmp.make_sharded_moe_apply(_moe_cfg(get_smoke_config(ARCH)), mesh, ("data",)))
    for S in SEQS:
        y, aux = apply(jnp.asarray(inp[f"x{S}"]), jnp.asarray(inp[f"rs{S}"]), p)
        _close(outs[0][f"moe_y{S}"], np.asarray(y))
        _close(outs[0][f"moe_aux{S}"], np.asarray(aux))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("T", DEC_T)
def test_decode_apply_matches_decode_moe(world, T, ep_dir):
    ref, outs = _outputs(world, ep_dir)
    for out in outs:
        _close(out[f"dec_y{T}"], ref[f"dec_y{T}"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("Tn", [1, 4])
def test_mesh_model_tokens_match_single_host(world, Tn, ep_dir):
    """a2a prefill, then the shard-sliced decode plane across a launch and
    its rollback-shaped relaunch (plan row 0 selected, lengths + 1): greedy
    tokens equal to the single-host reference's, logits within 1e-5."""
    ref, outs = _outputs(world, ep_dir)
    for out in outs:
        for key in (f"m{Tn}_prefill", f"m{Tn}_launch0", f"m{Tn}_launch1"):
            np.testing.assert_array_equal(np.argmax(out[key], -1), np.argmax(ref[key], -1), err_msg=key)
            _close(out[key], ref[key])


def test_indivisible_experts_are_refused():
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.moe_parallel import make_sharded_decode_apply, make_sharded_moe_apply

    cfg = dataclasses.replace(get_smoke_config(ARCH), decode_plane=True)
    mesh = Mesh({"data": 1, "model": 3}, {"data": 0, "model": 0}, {}, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_decode_apply(cfg, mesh, ())
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_moe_apply(cfg, mesh, ())
