"""PyTorch port, training across ranks: the sharded train step
(``launch.steps.build_train_step`` on a ``(data, model)`` mesh of gloo CPU
ranks, spawned, rendezvous through a file under the test's temporary
directory) against the JAX reference's ``build_train_step`` on an
Auto-axis host mesh of the same shape (its multi-device tests do not run
on this jax, ROADMAP Queue C, R2; the ``check_rep`` shim, R3), run in a
subprocess with 4 host devices beside the ranks.

Cases, from the same initial weights (the port's init, handed to the
reference by name) and the same numpy token batches (B 4, S 16):

* ``tp`` on Qwen3-MoE smoke at (2, 2) and (1, 2) (the ``a2a`` body:
  experts trained over ``model``, kernels 9, 3, 8, 10 and their backwards'
  plain versions), and at (1, 2) with S 15 (the ``psum`` body);
* ``fsdp`` on StarCoder2 smoke and on Qwen3-MoE smoke at (2, 2) (every
  leaf split over both axes; the MoE layers routed on each rank's rows).

Gates: after one step and after three, the loss and the grad norm within
1e-5 relative, every gathered param leaf within 1e-5 of the larger of its
largest magnitude and 0.1 (a floor of 1e-6 absolute, the one-device step's
own gate in ``tests/test_torch_train_step.py``: a leaf whose gradient is
zero in exact arithmetic, as the key bias's is, moves by AdamW's ratio of
rounding noise, ~1e-5 a step either way); after three, every optimizer
moment (Adafactor's factored ``vr`` / ``vc``, AdamW's ``m`` / ``v``)
within 1e-5 of the larger of its largest magnitude and 0.01.  The sides sum in other
orders (GSPMD splits the reference's dense products over ``model``; the
port gathers the weights and computes them whole), hence not bitwise.
And the plain backwards of kernels 8, 9 and 10 (the a2a body's) against
``jax.vjp`` of the reference's ``grouped_gemm`` / ``dispatch`` /
``combine``, with dropped assignments and empty slots, at 1e-5; and the
``psum`` body alone on bf16 activations at (1, 2), output and gradients
against the reference's at bf16's gate (``BF16_TOL``), its serving forward
bitwise its training one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_expert_parallel import run_ranks

B, S, LR, TOTAL = 4, 16, 1e-3, 10
QWEN, STARCODER = "qwen3-moe-235b-a22b", "starcoder2-3b"
# name -> (arch, strategy, mesh shape, sequence length)
CASES = {
    "tp_qwen_2x2": (QWEN, "tp", (2, 2), S),
    "tp_qwen_1x2": (QWEN, "tp", (1, 2), S),
    "tp_qwen_psum_1x2": (QWEN, "tp", (1, 2), 15),
    "fsdp_starcoder_2x2": (STARCODER, "fsdp", (2, 2), S),
    "fsdp_qwen_2x2": (QWEN, "fsdp", (2, 2), S),
}
TOL = 1e-5
# the psum body alone on bf16 activations (S odd, so the sequence does not
# split over 2 ranks); gate: chip_smoke.py's bf16 one, 2e-2 of each tensor's
# largest magnitude (the sides round the experts' products to bf16 at other
# points: the reference after each einsum, the port once per kernel)
PSUM_ARCH, PSUM_B, PSUM_S, BF16_TOL = QWEN, 2, 7, 2e-2
REPO = Path(__file__).resolve().parent.parent


def tokens(vocab: int, i: int, seq: int) -> np.ndarray:
    return np.random.default_rng(10 + i).integers(0, vocab, (B, seq)).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference: one subprocess with 4 host devices, every case
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent('''
    import inspect, json, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.parallel.moe_parallel as jmp
    if "check_rep" not in inspect.signature(jmp.shard_map).parameters:
        _sm = jax.shard_map
        def _shim(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return _sm(f, **kw)
        jmp.shard_map = _shim
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeCell
    from repro.launch.steps import build_train_step
    from repro.optim import cosine_schedule, make_optimizer

    d = sys.argv[1]
    spec = json.load(open(d + "/cases.json"))
    for name, (arch, strategy, shape, seq) in spec["cases"].items():
        cfg = get_smoke_config(arch)
        n = shape[0] * shape[1]
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        bundle = build_train_step(cfg, mesh, ShapeCell("t", seq, spec["B"], "train"), lr=spec["lr"],
                                  total_steps=spec["total"], strategy=strategy)
        names, _, treedef = _flatten(jax.eval_shape(bundle.model.init, jax.random.PRNGKey(0)))
        init = np.load(d + "/" + name + "_init.npz")
        params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(init[k]) for k in names])
        params = jax.device_put(params, bundle.in_shardings[0])
        opt = make_optimizer(cfg.optimizer, cosine_schedule(spec["lr"], 100, spec["total"]))
        o = jax.device_put(opt.init(params), bundle.in_shardings[1])
        fn = bundle.jit()
        out = {}
        with mesh:
            for i in range(3):
                toks = np.random.default_rng(10 + i).integers(0, cfg.vocab_size, (spec["B"], seq)).astype(np.int32)
                params, o, _, m = fn(params, o, jnp.int32(i), jnp.asarray(toks))
                out["loss%d" % i], out["gnorm%d" % i] = float(m["loss"]), float(m["grad_norm"])
                if i in (0, 2):
                    pn, pl, _ = _flatten(params)
                    out.update({"p%d/%s" % (i + 1, k): np.asarray(v) for k, v in zip(pn, pl)})
        on, ol, _ = _flatten(o)
        out.update({"o3/" + k: np.asarray(v) for k, v in zip(on, ol)})
        np.savez(d + "/" + name + "_ref.npz", **out)

    # the psum body alone in bf16 at (1, 2): output, aux and the gradients
    inp = dict(np.load(d + "/psum_bf16_in.npz"))
    cfg = get_smoke_config(spec["psum_arch"])
    mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:2])
    raw = jmp.make_sharded_moe_apply(cfg, mesh, ())
    dy, c = jnp.asarray(inp["dy"]), jnp.asarray(inp["c"])

    def f(x, p):
        y, aux = raw(x, None, p)
        return (y.astype(jnp.float32) * dy).sum() + (aux * c).sum(), (y, aux)

    x = jnp.asarray(inp["x"]).astype(jnp.bfloat16)
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    with mesh:
        (_, (y, aux)), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, p)
    out = {"y": np.asarray(y.astype(jnp.float32)), "aux": np.asarray(aux), "dx": np.asarray(dx.astype(jnp.float32))}
    out.update({"d_" + k: np.asarray(v) for k, v in dp.items()})
    np.savez(d + "/psum_bf16_ref.npz", **out)
    print("OK")
''')


def _start_reference(d: Path) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


# ---------------------------------------------------------------------------
# the port's ranks (this module imports no jax at top level)
# ---------------------------------------------------------------------------


def _gathered(cfg, tree, specs, mesh, prefix, out, lead):
    from repro_torch.checkpoint.bridge import leaves_from_params
    from repro_torch.parallel.sharding import gather_leaf, map_specs

    full = map_specs(lambda t, s: gather_leaf(t, s, mesh), tree, specs)
    if lead:
        out.update({prefix + n: make().numpy().copy() for n, make in leaves_from_params(cfg, full)})


def _port_case(name, d: Path, rank: int) -> None:
    import torch

    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import opt_state_pspecs

    arch, strategy, shape, seq = CASES[name]
    cfg = get_smoke_config(arch)
    mesh = make_host_mesh(*shape, device="cpu")
    step = build_train_step(cfg, mesh, ShapeCell("t", seq, B, "train"), lr=LR, total_steps=TOTAL, strategy=strategy)
    params = params_from_numpy(cfg, dict(np.load(d / f"{name}_init.npz")), "cpu", mesh, train=True,
                               strategy=strategy)
    opt = step.optimizer.init(params)
    out, lead = {}, rank == 0
    for i in range(3):
        params, opt, _, m = step(params, opt, i, torch.from_numpy(tokens(cfg.vocab_size, i, seq)))
        out[f"loss{i}"], out[f"gnorm{i}"] = float(m["loss"]), float(m["grad_norm"])
        if i in (0, 2):
            _gathered(cfg, params, step.specs, mesh, f"p{i + 1}/", out, lead)
    ospecs = opt_state_pspecs(opt, T.init_params(cfg, None, "meta", train=True), mesh, strategy=strategy)
    if set(opt) <= {"m", "v"}:
        for k in opt:
            _gathered(cfg, opt[k], ospecs[k], mesh, f"o3/{k}/", out, lead)
    else:
        _gathered(cfg, opt, ospecs, mesh, "o3/", out, lead)
    if lead:
        np.savez(d / f"{name}_port.npz", **out)


def _psum_bf16_case(d: Path, rank: int) -> None:
    """The psum body alone on bf16 activations over f32 master weights at
    (1, 2): its output and aux losses, then the gradients of a fixed
    cotangent's product with them (x, the router, this rank's expert
    slices); with no gradient asked for (serving) the same output, bitwise."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.moe_parallel import make_sharded_moe_apply
    from repro_torch.parallel.sharding import expert_slice

    cfg = get_smoke_config(PSUM_ARCH)
    mesh = make_host_mesh(1, 2, device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "psum_bf16_in.npz").items()}
    sl = expert_slice(cfg, mesh)
    p = {k: (inp[k] if k == "router" else inp[k][sl].clone()).requires_grad_(True)
         for k in ("router", "w_gate", "w_up", "w_down")}
    x = inp["x"].to(torch.bfloat16).requires_grad_(True)
    apply = make_sharded_moe_apply(cfg, mesh, ())
    with torch.enable_grad():
        y, aux = apply(x, None, p)
        loss = (y.float() * inp["dy"]).sum() + (aux * inp["c"]).sum()
        grads = torch.autograd.grad(loss, [x, *p.values()])
    with torch.no_grad():
        y_serve, aux_serve = apply(x, None, p)
    assert torch.equal(y_serve, y.detach()) and torch.equal(aux_serve, aux.detach()), "serving = training forward"
    out = {"y": y.detach().float().numpy(), "aux": aux.detach().numpy(), "dx": grads[0].float().numpy()}
    out.update({"d_" + k: g.numpy() for k, g in zip(p, grads[1:])})
    np.savez(d / f"psum_bf16_port{rank}.npz", **out)


def _worker(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / f'rendezvous{world}'}", rank=rank, world_size=world)
    try:
        for name, (_, _, shape, _) in CASES.items():
            if shape[0] * shape[1] == world:
                _port_case(name, d, rank)
        if world == 2:
            _psum_bf16_case(d, rank)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process
# ---------------------------------------------------------------------------

_STATE: dict = {}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The cases' initial weights written, the reference started."""
    from repro_torch.checkpoint.bridge import leaves_from_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model

    d = tmp_path_factory.mktemp("train_mesh")
    for name, (arch, _, _, _) in CASES.items():
        cfg = get_smoke_config(arch)
        params = Model(cfg, "cpu").init(0, train=True)
        np.savez(d / f"{name}_init.npz", **{n: make().numpy() for n, make in leaves_from_params(cfg, params)})
    moe = Model(get_smoke_config(PSUM_ARCH), "cpu").init(1, train=True)["layers"][0]["moe"]
    rng = np.random.default_rng(7)
    dm = moe["router"].shape[0]
    np.savez(d / "psum_bf16_in.npz", x=rng.standard_normal((PSUM_B, PSUM_S, dm)).astype(np.float32),
             dy=rng.standard_normal((PSUM_B, PSUM_S, dm)).astype(np.float32), c=np.array([0.3, 0.7], np.float32),
             **{k: moe[k].numpy() for k in ("router", "w_gate", "w_up", "w_down")})
    (d / "cases.json").write_text(json.dumps({"cases": CASES, "B": B, "lr": LR, "total": TOTAL,
                                              "psum_arch": PSUM_ARCH}))
    proc = _start_reference(d)
    yield d, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _results(work, name):
    d, proc = work
    world = int(np.prod(CASES[name][2]))
    if world not in _STATE:
        run_ranks(_worker, world, d, timeout=240)
        _STATE[world] = True
    if "ref" not in _STATE:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0 and "OK" in out, f"reference failed:\n{out}\n{err[-4000:]}"
        _STATE["ref"] = True
    return dict(np.load(d / f"{name}_port.npz")), dict(np.load(d / f"{name}_ref.npz"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_reference_on_the_same_mesh(work, name):
    got, want = _results(work, name)
    for i in range(3):
        for key in (f"loss{i}", f"gnorm{i}"):
            assert abs(float(got[key]) - float(want[key])) <= TOL * abs(float(want[key])), (name, key)
    for prefix, floor in (("p1/", 0.1), ("p3/", 0.1), ("o3/", 1e-2)):
        names = sorted(k for k in want if k.startswith(prefix))
        assert names and names == sorted(k for k in got if k.startswith(prefix)), (name, prefix)
        for k in names:
            g, w = got[k].astype(np.float64), want[k].astype(np.float64)
            assert g.shape == w.shape, (name, k)
            assert float(np.abs(g - w).max()) <= TOL * max(float(np.abs(w).max()), floor), (name, k)
    if CASES[name][0] == QWEN:
        assert any(k.endswith("/vr") for k in want) and any("router" in k for k in want)
        moved = [k for k in want if k.startswith("p3/") and k.endswith("router")]
        init = np.load(work[0] / f"{name}_init.npz")
        assert moved and all(np.abs(got[k] - init[k[3:]]).max() > 0 for k in moved), "every router moves"


def test_psum_body_in_bf16_matches_reference(work):
    """The psum body's forward and gradient on bf16 activations, two ranks,
    against the reference's ``make_sharded_moe_apply`` on a (1, 2)
    Auto-axis mesh: each rank's part rounded to bf16 before the sum, as the
    reference's body sums them."""
    d = work[0]
    _results(work, "tp_qwen_psum_1x2")
    want = dict(np.load(d / "psum_bf16_ref.npz"))
    got = [dict(np.load(d / f"psum_bf16_port{r}.npz")) for r in range(2)]
    for k in ("y", "aux", "dx", "d_router"):  # whole on every rank
        assert np.array_equal(got[0][k], got[1][k]), k
    for k in ("d_w_gate", "d_w_up", "d_w_down"):  # each rank's expert slice
        got[0][k] = np.concatenate([got[0][k], got[1][k]])
    assert sorted(got[0]) == sorted(want)
    for k, w in want.items():
        g = got[0][k].astype(np.float64)
        assert g.shape == w.shape, k
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert scale > 0 and err <= BF16_TOL * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# the a2a body's plain backwards against jax.vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 0.5), (8, 1.0)])
def test_plain_backwards_of_kernels_8_9_10_match_jax_vjp(k, cf):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import control_plane as jcp
    from repro.core.plans import DispatchPlan as JPlan
    from repro.kernels.grouped_gemm.ref import grouped_gemm as j_grouped_gemm
    from repro_torch.core.control_plane import capacity_for, route_topk
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm_bwd
    from repro_torch.kernels.moe_dispatch.ops import combine_bwd, dispatch_bwd

    T, d, E, f = 37, 24, 8, 20
    rng = np.random.default_rng(k)
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32)
    C = capacity_for(T, E, k, cf)
    plan, _ = route_topk(torch.from_numpy(x), torch.from_numpy(router), k, C)
    cidx, w = plan.flat_combine_words()
    idx = plan.flat_dispatch_idx()
    assert int((idx >= T).sum()) > 0 or cf < 1, "empty slots"
    if cf < 1:
        assert int((cidx >= E * C).sum()) > 0, "dropped assignments"
    jplan = JPlan(*(jnp.asarray(t.numpy()) for t in plan[:4]))

    dslots = rng.standard_normal((E, C, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jcp.dispatch(xx, jplan), jnp.asarray(x))
    np.testing.assert_allclose(dispatch_bwd(torch.from_numpy(dslots), cidx, T).numpy(),
                               np.asarray(vjp(jnp.asarray(dslots))[0]), rtol=0, atol=TOL)

    ys = rng.standard_normal((E, C, d)).astype(np.float32)
    dy = rng.standard_normal((T, d)).astype(np.float32)
    cw = jnp.asarray(plan.combine_w.numpy())
    _, vjp = jax.vjp(lambda yy, ww: jcp.combine(yy, jplan._replace(combine_w=ww)), jnp.asarray(ys), cw)
    want_s, want_w = vjp(jnp.asarray(dy))
    got_s, got_w = combine_bwd(torch.from_numpy(dy), torch.from_numpy(ys), cidx, w, idx)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_w.numpy().reshape(T, k), np.asarray(want_w), rtol=0, atol=TOL * 10)

    xg = rng.standard_normal((E, C, f)).astype(np.float32)
    wg = rng.standard_normal((E, f, d)).astype(np.float32)
    dg = rng.standard_normal((E, C, d)).astype(np.float32)
    _, vjp = jax.vjp(j_grouped_gemm, jnp.asarray(xg), jnp.asarray(wg))
    for got, want in zip(grouped_gemm_bwd(*(torch.from_numpy(a) for a in (xg, wg, dg))), vjp(jnp.asarray(dg))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL * 10)
