"""PyTorch port, training: the loss and its gradient against the JAX
reference's ``jax.value_and_grad(Model.forward_train)``, three steps of
``build_train_step`` against the reference's jitted one, kernel 7's plain
backward against autograd through its plain forward, and the f32 master
weights.  CPU only (every kernel wrapper runs its plain version).

Gates: the loss within 1e-5 relative, every gradient leaf within 1e-4 of
that leaf's largest magnitude (f32 both sides, sums in other orders), and
after three AdamW steps the losses within 1e-5 relative and the params
within 1e-6.  Stacks: StarCoder2-3B (smoke; QKV bias; also under remat), a
mixed ("attn", "local") Qwen1.5-4B stack, every layer local (Qwen3-32B's
smoke config under ``attention_kind="local"``) and Phi-3-Vision with its
frontend positions masked from the loss (S >= F, caveat R7).  MoE,
RG-LRU and Mamba-2 stacks train too (``test_torch_train_moe.py``,
``test_torch_train_rec.py``, ``test_torch_train_ssm.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_cases import bridge, host_mesh
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeCell as JCell
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.model import Model as JModel
from repro.optim import cosine_schedule as j_cosine
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ShapeCell
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model as TModel
from repro_torch.optim import tree_leaves, tree_unflatten

STACKS = {
    "starcoder2": ("starcoder2-3b", {}, False),
    "starcoder2_remat": ("starcoder2-3b", dict(remat=True), False),
    "mixed_local": ("qwen1.5-4b", dict(block_pattern=("attn", "local"), local_window=8), False),
    "all_local": ("qwen3-32b", dict(attention_kind="local", local_window=8), False),
    "vision_frontend": ("phi-3-vision-4.2b", {}, True),
}


def _configs(stack):
    arch, extra, _ = STACKS[stack]
    return dataclasses.replace(j_smoke(arch), **extra), dataclasses.replace(t_smoke(arch), **extra)


def _batch(cfg, B, S, seed, frontend):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    feats = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32) if frontend else None
    return tokens, feats


def _port_leaves(tcfg, jtree) -> dict:
    """A reference tree (params or gradients) in the port's training layout."""
    return params_from_numpy(tcfg, bridge(jtree), "cpu", train=True)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_loss_and_gradients_match_reference(stack):
    jcfg, tcfg = _configs(stack)
    tokens, feats = _batch(jcfg, 2, 16, 1, STACKS[stack][2])
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.forward_train(p, jnp.asarray(tokens), None if feats is None else jnp.asarray(feats)),
        has_aux=True)(jp)

    tm = TModel(tcfg, device="cpu")
    tp = _port_leaves(tcfg, jp)
    leaves = tree_leaves(tp)
    assert all(t.dtype == torch.float32 for t in leaves)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = tm.forward_train(tp, torch.from_numpy(tokens), None if feats is None else torch.from_numpy(feats))
    grads = torch.autograd.grad(tloss, leaves)
    assert sorted(tmet) == sorted(jmet) == ["ce", "lb_loss", "loss", "z_loss"]
    for name in jmet:
        assert abs(float(tmet[name].detach()) - float(jmet[name])) <= 1e-5 * max(abs(float(jmet[name])), 1e-30), name
    want = tree_leaves(_port_leaves(tcfg, jgrads))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_three_train_steps_match_reference():
    """``build_train_step`` (AdamW, the reference's cosine schedule, clip
    1.0) from the reference's initial weights, three batches, against the
    reference's jitted step on an Auto-axis (1, 1) mesh (caveat R2)."""
    jcfg, tcfg = _configs("starcoder2")
    B, S, lr, total = 2, 16, 3e-4, 10
    bundle = j_build_train_step(jcfg, host_mesh(), JCell("t", S, B, "train"), lr=lr, total_steps=total)
    jstep_fn = bundle.jit()
    jp = bundle.model.init(jax.random.PRNGKey(0))
    jo = j_make_optimizer(jcfg.optimizer, j_cosine(lr, 100, total)).init(jp)
    ts = build_train_step(tcfg, "cpu", ShapeCell("t", S, B, "train"), lr=lr, total_steps=total)
    tp = _port_leaves(tcfg, jp)
    to = ts.optimizer.init(tp)
    jstep, tstep = jnp.int32(0), 0
    for i in range(3):
        tokens, _ = _batch(jcfg, B, S, 10 + i, False)
        jp, jo, jstep, jm = jstep_fn(jp, jo, jstep, jnp.asarray(tokens))
        tp, to, tstep, tm = ts(tp, to, tstep, torch.from_numpy(tokens))
        assert tstep == int(jstep) == i + 1
        assert sorted(tm) == sorted(jm)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    for g, w in zip(tree_leaves(tp), tree_leaves(_port_leaves(tcfg, jp))):
        assert float((g - w).abs().max()) <= 1e-6
    for key in ("m", "v"):
        for g, w in zip(tree_leaves(to[key]), tree_leaves(_port_leaves(tcfg, jo[key]))):
            assert float((g - w).abs().max()) <= 1e-6


# B, S, nq, nkv, hd, causal, window
PLAIN_BWD_CASES = {"causal_gqa": (2, 19, 6, 2, 16, True, 0), "windowed_mqa": (1, 23, 4, 1, 8, True, 5),
                   "mha_noncausal": (2, 11, 3, 3, 16, False, 0), "windowed_gqa": (1, 30, 8, 2, 32, True, 9)}


@pytest.mark.parametrize("case", sorted(PLAIN_BWD_CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(case):
    B, S, nq, nkv, hd, causal, window = PLAIN_BWD_CASES[case]
    rng = np.random.default_rng(S)
    q = torch.from_numpy(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).requires_grad_(True)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).requires_grad_(True)
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((B, S, nq, hd)).astype(np.float32))
    out = fa_ref.flash_attention(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(out, (q, k, v), do)
    o2, lse = fa_ref.flash_attention_lse(q.detach(), k.detach(), v.detach(), causal=causal, window=window)
    assert torch.equal(o2, out.detach())
    got = fa_ref.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o2, lse, do, causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * max(1.0, float(w.abs().max()))
    # the autograd entry point takes both plain versions on the CPU and launches nothing
    before = (fa_ops.flash_attention_kernel.launches, fa_ops.flash_attention_bwd_kernel.launches)
    qa, ka, va = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fa_ops.flash_attention_train(qa, ka, va, causal=causal, window=window).backward(do)
    assert all(torch.equal(t.grad, g) for t, g in zip((qa, ka, va), got))
    assert (fa_ops.flash_attention_kernel.launches, fa_ops.flash_attention_bwd_kernel.launches) == before


def test_training_init_keeps_f32_master_weights_and_no_tied_copy():
    cfg = dataclasses.replace(t_smoke("starcoder2-3b"), dtype="bfloat16")
    tm = TModel(cfg, device="cpu")
    assert {t.dtype for t in tree_leaves(tm.init(0, train=True))} == {torch.float32}
    assert torch.bfloat16 in {t.dtype for t in tree_leaves(tm.init(0))}
    tied = TModel(t_smoke("recurrentgemma-2b"), device="cpu")
    assert "unembed" not in tied.init(0, train=True) and "unembed" in tied.init(0)
    params = tm.init(0, train=True)
    assert tree_leaves(tree_unflatten(params, tree_leaves(params)))[3] is tree_leaves(params)[3]
