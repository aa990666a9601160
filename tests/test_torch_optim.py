"""PyTorch port, optimizers: ``adamw`` (the reference's decay mask: 1-D
leaves undecayed), ``adafactor`` (factored second moments of >= 2-D
leaves), ``clip_by_global_norm`` and the schedules against the JAX
reference on the CPU, leaf for leaf over 3 updates of a seeded numpy tree.

Gate: 1e-6 absolute on params and state (f32 both sides; the port updates
in place, the reference adds an update tree)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro.checkpoint.manager import _flatten
from repro_torch import optim as T

TOL = 1e-6


def _tree(rng):
    """A params-like tree: 1-D norms and biases, 2-D and 3-D weights, a list."""
    return {
        "embed": rng.standard_normal((40, 8)).astype(np.float32) * 0.02,
        "final_norm": rng.standard_normal((8,)).astype(np.float32) * 0.1,
        "layers": [{"ln1": rng.standard_normal((8,)).astype(np.float32) * 0.1,
                    "attn": {"wq": rng.standard_normal((8, 2, 4)).astype(np.float32),
                             "bq": rng.standard_normal((2, 4)).astype(np.float32)}}
                   for _ in range(2)],
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _numpy_leaves(tree) -> dict:
    """{reference leaf name: array} of a JAX tree or of the port's."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = jax.tree.map(lambda t: t.numpy().copy(), tree)
    names, leaves, _ = _flatten(tree)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


def _assert_trees_close(got, want):
    g, w = _numpy_leaves(got), _numpy_leaves(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name], w[name], rtol=0, atol=TOL, err_msg=name)


SCHEDULES = {"constant": 3e-2, "cosine": ("cosine_schedule", (3e-2, 2, 6)), "warmup": ("linear_warmup", (3e-2, 4))}


def _lr(pkg, kind):
    spec = SCHEDULES[kind]
    if not isinstance(spec, tuple):
        return spec
    return getattr(pkg, spec[0])(*spec[1])


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_three_updates(name, schedule):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo, to = J.make_optimizer(name, _lr(J, schedule)), T.make_optimizer(name, _lr(T, schedule))
    jp, tp = _jax(params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    _assert_trees_close(ts, js)  # the same state leaves, named as the reference names them
    for step in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, js = jo.update(_jax(grads), js, jp, jnp.int32(step))
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        tp, ts = to.update(_torch(grads), ts, tp, step)
        _assert_trees_close(tp, jp)
        _assert_trees_close(ts, js)


def test_adamw_leaves_one_dimensional_params_undecayed():
    """With a zero gradient only weight decay moves a leaf: >= 2-D leaves
    shrink, 1-D leaves stay, as the reference's default mask decides."""
    params = _torch(_tree(np.random.default_rng(1)))
    before = _numpy_leaves(params)
    opt = T.adamw(1e-2)
    zeros = jax.tree.map(torch.zeros_like, params)
    params, _ = opt.update(zeros, opt.init(params), params, 0)
    after = _numpy_leaves(params)
    for name, arr in before.items():
        if arr.ndim >= 2:
            np.testing.assert_allclose(after[name], arr * (1 - 1e-2 * 0.1), rtol=1e-6)
        else:
            np.testing.assert_array_equal(after[name], arr)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(np.random.default_rng(2))
    jg, jn = J.clip_by_global_norm(_jax(grads), max_norm)
    tg, tn = T.clip_by_global_norm(_torch(grads), max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    np.testing.assert_allclose(float(T.global_norm(_torch(grads))), float(J.global_norm(_jax(grads))), rtol=1e-6)
    _assert_trees_close(tg, jg)


def test_schedules_match_reference_step_by_step():
    pairs = [(J.cosine_schedule(3e-4, 100, 1000), T.cosine_schedule(3e-4, 100, 1000)),
             (J.cosine_schedule(1.0, 3, 10, floor=0.0), T.cosine_schedule(1.0, 3, 10, floor=0.0)),
             (J.linear_warmup(2e-3, 7), T.linear_warmup(2e-3, 7))]
    for j, t in pairs:
        for step in (0, 1, 2, 3, 5, 7, 50, 99, 100, 101, 500, 999, 1000, 2000):
            want = float(j(jnp.int32(step)))
            assert isinstance(t(step), float)
            assert t(step) == want, (step, t(step), want)
            assert t(torch.tensor(step)) == want


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        T.make_optimizer("sgd", 1e-3)
