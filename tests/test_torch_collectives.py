"""PyTorch port, ``parallel/collectives.py`` across ranks: four gloo CPU
ranks (spawned, rendezvous through a file under the test's temporary
directory) on a 2-pod x 2-data mesh (``make_production_mesh(multi_pod=True)``
over the 4 ranks) against the JAX reference's
``shard_map`` on an Auto-axis host mesh of the same shape (its own
multi-device test does not run on this jax, ROADMAP Queue C, R2), run in a
subprocess with 4 host devices.

* ``hierarchical_grad_sync`` (exact, and int8-compressed over ``pod``) and
  ``compressed_psum`` over ``pod``: every rank's result equals the
  reference device's at 1e-6 (the same f32 sums of two, the same shared
  scale and int8 codes); the compressed mean is within the reference's own
  bound, ``4 * scale + 1e-6`` of the exact mean (scale = amax / 127);
* ``tree_bytes`` / ``control_bytes`` equal the reference's;
* the differentiable collectives' backwards, on every rank: ``gather``
  keeps the rank's slice of a replicated cotangent (with ``reduce`` the
  reduce-scatter of partial ones), ``split`` gathers its blocks' gradients,
  ``sum_grad`` and ``pmean`` sum / scale, ``psum`` passes its (replicated)
  cotangent, ``all_to_all`` sends the gradient's blocks back.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from test_torch_expert_parallel import run_ranks

REPO = Path(__file__).resolve().parent.parent
ROWS, COLS = 4, 32

_REFERENCE = textwrap.dedent('''
    import sys
    from functools import partial
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.parallel.collectives import compressed_psum, hierarchical_grad_sync
    d = sys.argv[1]
    g_all = np.load(d + "/g.npy")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
    out = {}
    for compress in (True, False):
        @partial(jax.shard_map, mesh=mesh, in_specs=P(("pod", "data")), out_specs=P(("pod", "data")))
        def sync(g):
            return hierarchical_grad_sync({"g": g}, intra_axes=("data",), inter_axis="pod", compress_inter=compress,
                                          mean=True, axis_sizes={"data": 2, "pod": 2})["g"]
        out["sync%d" % compress] = np.asarray(sync(jnp.asarray(g_all)))

    @partial(jax.shard_map, mesh=mesh, in_specs=P(("pod", "data")), out_specs=P(("pod", "data")))
    def cpsum(g):
        return compressed_psum(g, "pod")
    out["cpsum"] = np.asarray(cpsum(jnp.asarray(g_all)))
    np.savez(d + "/ref.npz", **out)
    print("OK")
''')


def _check_autograd(mesh, rank) -> None:
    """The differentiable collectives' backwards on a 2-rank ``data`` group."""
    import torch

    from repro_torch.parallel.collectives import all_to_all, gather, pmean, psum, split, sum_grad

    g = mesh.group("data")
    r, n = mesh.coords["data"], 2
    base = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    c = [torch.full((4, 3), 10.0 * (q + 1)) + base for q in range(n)]  # rank q's cotangent
    same = c[0]

    x = (base[2 * r:2 * r + 2] + r).requires_grad_(True)  # a shard
    (grad,) = torch.autograd.grad((gather(x, g, 0) * same).sum(), [x])
    assert torch.equal(grad, same[2 * r:2 * r + 2]), "gather: the own slice of a replicated cotangent"
    (grad,) = torch.autograd.grad((gather(x, g, 0, reduce=True) * c[r]).sum(), [x])
    assert torch.equal(grad, (c[0] + c[1])[2 * r:2 * r + 2]), "gather(reduce): the reduce-scatter"
    w = base.clone().requires_grad_(True)  # held whole by both ranks
    y = split(w, g, 0)
    assert torch.equal(y.detach(), base[2 * r:2 * r + 2])
    (grad,) = torch.autograd.grad((y * c[r][2 * r:2 * r + 2]).sum(), [w])
    assert torch.equal(grad, torch.cat([c[0][0:2], c[1][2:4]])), "split: the blocks' gradients gathered"
    (grad,) = torch.autograd.grad((sum_grad(w, g) * c[r]).sum(), [w])
    assert torch.equal(grad, c[0] + c[1]), "sum_grad: the gradients summed"
    (grad,) = torch.autograd.grad((psum(w * (r + 1), g) * same).sum(), [w])
    assert torch.equal(grad, same * (r + 1)), "psum: the replicated cotangent passed on"
    (grad,) = torch.autograd.grad((pmean(w, g, n, 0.25) * same).sum(), [w])
    assert torch.equal(grad, same * 0.25), "pmean: the cotangent scaled"
    blocks = (base + 100 * r).requires_grad_(True)  # block j (rows 2j, 2j+1) goes to rank j
    got = all_to_all(blocks, g)
    assert torch.equal(got.detach(), torch.cat([base[2 * r:2 * r + 2], base[2 * r:2 * r + 2] + 100]))
    (grad,) = torch.autograd.grad((got * c[r]).sum(), [blocks])
    assert torch.equal(grad, torch.cat([c[0][2 * r:2 * r + 2], c[1][2 * r:2 * r + 2]])), "all_to_all: blocks back"


def _worker(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.collectives import compressed_psum, hierarchical_grad_sync

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")  # (pod 2, data 2, model 1) over the 4 ranks
        assert mesh.shape == {"pod": 2, "data": 2, "model": 1}
        g = torch.from_numpy(np.load(d / "g.npy")[rank].copy())
        out = {}
        for compress in (True, False):
            got = hierarchical_grad_sync({"g": g}, mesh, intra_axes=("data",), inter_axis="pod",
                                         compress_inter=compress, mean=True)
            out[f"sync{int(compress)}"] = got["g"].numpy()
        out["cpsum"] = compressed_psum(g, mesh.group("pod")).numpy()
        _check_autograd(mesh, rank)
        np.savez(d / f"out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_collectives_match_the_reference_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    g_all = rng.standard_normal((ROWS, COLS)).astype(np.float32)
    np.save(tmp_path / "g.npy", g_all)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", "import repro.compat as c; c.install_shard_map()\n" + _REFERENCE,
                            str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        run_ranks(_worker, 4, tmp_path, timeout=120)
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0 and "OK" in out, err[-3000:]
    want = dict(np.load(tmp_path / "ref.npz"))
    exact = g_all.mean(axis=0)
    scale = np.abs(g_all).max() / 127
    for rank in range(ROWS):
        got = dict(np.load(tmp_path / f"out{rank}.npz"))
        for key in ("sync0", "sync1", "cpsum"):
            np.testing.assert_allclose(got[key], want[key][rank], rtol=0, atol=1e-6, err_msg=f"{key} rank {rank}")
        np.testing.assert_allclose(got["sync0"], exact, rtol=0, atol=1e-6)
        assert float(np.abs(got["sync1"] - exact).max()) < 4 * scale + 1e-6


def test_tree_bytes_match_the_reference():
    import jax.numpy as jnp
    import torch

    from repro.parallel.collectives import control_bytes as j_control_bytes
    from repro.parallel.collectives import tree_bytes as j_tree_bytes
    from repro_torch.parallel.collectives import control_bytes, tree_bytes

    jt = {"a": jnp.zeros((4, 4), jnp.float32), "b": [jnp.zeros((2,), jnp.int8), jnp.zeros((3, 5), jnp.bfloat16)]}
    tt = {"a": torch.zeros((4, 4)), "b": [torch.zeros((2,), dtype=torch.int8), torch.zeros((3, 5), dtype=torch.bfloat16)]}
    assert tree_bytes(tt) == j_tree_bytes(jt) == 4 * 4 * 4 + 2 + 30
    assert control_bytes(tt) == j_control_bytes(jt)
