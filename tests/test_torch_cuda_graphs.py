"""PyTorch port, on the card: the compiled decode launch (``launch/steps.py``)
replays its CUDA graph bitwise as the eager launch runs.

Runs only where ``torch.cuda.is_available()``; elsewhere every test skips
(a CUDA graph has no CPU mode).  Imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py

Gates, at smoke shapes (f32): replayed launches leave logits and every
cache leaf bitwise equal to eager ``Model.decode_tokens`` launches on the
same inputs, on each plane (contiguous chain, contiguous tree with its
compiled commit, paged chain, paged branchy tree, int8, hybrid, SSM), and
each replay counts the eager launch's kernel launches; the compiled
contiguous tree commit equals the eager one; a capture that meets a host
sync raises, and no call runs the launch eagerly instead; replays stay
bitwise eager after the caches of the device constants they read are
cleared (the step holds those tensors).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.steps import TreeCommit, build_spec_serve_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from _torch_decode_cases import B, CASES, LAUNCHES, MAX_LEN, admitted, case, clone, inputs, root_paths

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _admitted(name, dev):
    cfg, tree, _ = case(name)
    return (cfg, tree, *admitted(cfg, dev))


def _assert_caches_equal(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        for leaf in x:
            assert torch.equal(x[leaf], y[leaf]), (i, leaf)


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_launches_are_bitwise_eager(cuda, name):
    cfg, tree, model, params, cache = _admitted(name, cuda)
    eager = clone(cache)
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, max_len=MAX_LEN)
    commit = TreeCommit(cache, batch=B, T=tree.num_nodes) if tree and not cfg.paged else None
    rng = np.random.default_rng(1)
    for i in range(LAUNCHES):
        tokens, lengths, prev, kw = inputs(cfg, tree, rng)
        reset_launch_counts()
        want = model.decode_tokens(params, eager, tokens, lengths, prev, tree=tree, max_len=MAX_LEN, **kw)
        eager_counts = launch_counts()
        reset_launch_counts()
        ids, _ = step(tokens, lengths, prev, **kw)
        assert launch_counts() == eager_counts
        assert (step.launcher.graph is not None) and torch.equal(step.logits, want), f"launch {i}"
        np.testing.assert_array_equal(ids, want.argmax(-1).cpu().numpy())
        if commit is not None:
            path = root_paths(tree, rng)
            Model.commit_tree_path(eager, lengths, path)
            commit(lengths, path)
        torch.cuda.synchronize()
        _assert_caches_equal(cache, eager)


def test_compiled_tree_commit_equals_eager(cuda):
    cfg, tree, model, params, cache = _admitted("tree", cuda)
    eager = clone(cache)
    commit = TreeCommit(cache, batch=B, T=tree.num_nodes)
    rng = np.random.default_rng(5)
    for _ in range(LAUNCHES):
        lengths, path = rng.integers(0, MAX_LEN - tree.num_nodes + 1, B), root_paths(tree, rng)
        Model.commit_tree_path(eager, lengths, path)
        commit(lengths, path)
        torch.cuda.synchronize()
        _assert_caches_equal(cache, eager)
    assert commit.launcher.graph is not None


def test_a_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    cfg, tree, model, params, cache = _admitted("chain", cuda)
    rms_norm = L.rms_norm

    def syncing(x, scale, eps=1e-6):
        float(x.sum())  # a read back to the host: legal eagerly, not inside a capture
        return rms_norm(x, scale, eps)

    monkeypatch.setattr(L, "rms_norm", syncing)
    step = build_spec_serve_step(model, params, cache, batch=B, max_len=MAX_LEN)
    tokens, lengths, prev, _ = inputs(cfg, tree, np.random.default_rng(6))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(tokens, lengths, prev)
        assert step.launcher.graph is None
    torch.cuda.synchronize()


def test_replays_read_the_constants_the_step_holds(cuda):
    cfg, tree, model, params, cache = _admitted("tree", cuda)
    eager = clone(cache)
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, max_len=MAX_LEN)
    rng = np.random.default_rng(7)
    for launch in range(3):
        tokens, lengths, prev, kw = inputs(cfg, tree, rng)
        want = model.decode_tokens(params, eager, tokens, lengths, prev, tree=tree, max_len=MAX_LEN, **kw)
        step(tokens, lengths, prev, **kw)
        assert torch.equal(step.logits, want), f"launch {launch}"
        # the caches let go of the rotary frequencies and the tree's words;
        # memory they held, were it freed, would be handed out and overwritten
        L.rope_frequencies.cache_clear()
        T._tree_tensors.cache_clear()
        garbage = []
        for stream in (torch.cuda.current_stream(), step.launcher.graphs.stream):
            with torch.cuda.stream(stream):
                garbage += [torch.full((n,), -7, dtype=dt, device=cuda) for n in (8, 16, 32, 64, 128)
                            for dt in (torch.float32, torch.int64, torch.int32)]
        torch.cuda.synchronize()
    assert step.launcher.graph is not None
