"""PyTorch port, training RG-LRU stacks: RecurrentGemma-2B's smoke config
(``rec, rec, attn`` over local attention, tied embeddings) against the JAX
reference on the CPU: the loss and every gradient leaf against
``jax.value_and_grad(Model.forward_train)`` (the reference's ``rec_block``
differentiates its associative ``linear_scan``), also under remat and with
a pattern-incomplete tail, and three ``build_train_step`` steps with AdamW
(its decay mask over the reference's stacked leaves) against the
reference's jitted step.  CPU only: kernel 12 and its backward run their
plain versions.

Gates (those of ``tests/test_torch_train_step.py``): the loss within 1e-5
relative, every gradient leaf within 1e-4 of that leaf's largest
magnitude; after three steps losses and grad norms within 1e-5 relative,
params and AdamW's moments within 1e-6.
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
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model as TModel
from repro_torch.optim import tree_leaves

ARCH = "recurrentgemma-2b"
B, S = 2, 24  # S past the smoke config's window of 16
STACKS = {"rec": {}, "rec_remat": dict(remat=True), "rec_tail": dict(num_layers=5)}


def _configs(stack):
    extra = STACKS[stack]
    return dataclasses.replace(j_smoke(ARCH), **extra), dataclasses.replace(t_smoke(ARCH), **extra)


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_leaves(tcfg, jtree) -> dict:
    return params_from_numpy(tcfg, bridge(jtree), "cpu", train=True)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_loss_and_gradients_match_reference(stack):
    jcfg, tcfg = _configs(stack)
    assert "rec" in tcfg.layer_kinds
    tokens = _tokens(jcfg, 1)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    (jloss, jmet), jgrads = jax.value_and_grad(lambda p: jm.forward_train(p, jnp.asarray(tokens)), has_aux=True)(jp)

    tm = TModel(tcfg, device="cpu")
    tp = _port_leaves(tcfg, jp)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = tm.forward_train(tp, torch.from_numpy(tokens))
    grads = torch.autograd.grad(tloss, leaves)
    for name in jmet:
        assert abs(float(tmet[name].detach()) - float(jmet[name])) <= 1e-5 * max(abs(float(jmet[name])), 1e-30), name
    want = tree_leaves(_port_leaves(tcfg, jgrads))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_three_adamw_steps_match_reference():
    """``build_train_step`` (AdamW, the reference's cosine schedule, clip
    1.0) from the reference's initial weights, three batches, against the
    reference's jitted step on an Auto-axis (1, 1) mesh (caveat R2).  The
    RG-LRU's 1-D leaves (``lam`` and ``alpha_r`` start far from 0) are
    decayed as the reference's stacked (1, W) leaves are."""
    jcfg, tcfg = _configs("rec")
    lr, total = 3e-4, 10
    bundle = j_build_train_step(jcfg, host_mesh(), JCell("t", S, B, "train"), lr=lr, total_steps=total)
    jstep_fn = bundle.jit()
    jp = bundle.model.init(jax.random.PRNGKey(0))
    jo = j_make_optimizer(jcfg.optimizer, j_cosine(lr, 100, total)).init(jp)
    ts = build_train_step(tcfg, "cpu", ShapeCell("t", S, B, "train"), lr=lr, total_steps=total)
    assert tcfg.optimizer == "adamw"
    tp = _port_leaves(tcfg, jp)
    to = ts.optimizer.init(tp)
    jstep, tstep = jnp.int32(0), 0
    for i in range(3):
        tokens = _tokens(jcfg, 10 + i)
        jp, jo, jstep, jm = jstep_fn(jp, jo, jstep, jnp.asarray(tokens))
        tp, to, tstep, tm = ts(tp, to, tstep, torch.from_numpy(tokens))
        assert tstep == int(jstep) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * float(jm[key]), (i, key)
    for g, w in zip(tree_leaves(tp), tree_leaves(_port_leaves(tcfg, jp))):
        assert float((g - w).abs().max()) <= 1e-6
    for key in ("m", "v"):
        for g, w in zip(tree_leaves(to[key]), tree_leaves(_port_leaves(tcfg, jo[key]))):
            assert float((g - w).abs().max()) <= 1e-6


def test_train_cli_trains_an_rglru_smoke_stack(capsys, tmp_path):
    from repro_torch.launch import train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                       "--batch", "2", "--ckpt", str(tmp_path)]) == 0
    assert "finished: step 2, loss " in capsys.readouterr().out
