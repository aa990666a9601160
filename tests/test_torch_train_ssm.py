"""PyTorch port, training Mamba-2 stacks: Mamba-2-2.7B's smoke config
(``ssm`` layers, tied embeddings, chunk 16) against the JAX reference on
the CPU: the loss and every gradient leaf against
``jax.value_and_grad(Model.forward_train)`` (the reference differentiates
its jnp ``ssd_chunked`` through ``lax.scan``), also under remat and with a
pattern-incomplete tail (an ``("ssm", "ssm")`` pattern over 3 layers), and
three ``build_train_step`` steps with AdamW (its decay mask over the
reference's stacked leaves: ``A_log``, ``D``, ``dt_bias``, ``norm_scale``
and ``conv_b`` stack to 2-D and are decayed, as the reference's step
decays them) against the reference's jitted step; the train CLI.  CPU
only: kernel 11 and its backward run their plain versions.

Gates (those of ``tests/test_torch_train_step.py``): the loss within 1e-5
relative, every gradient leaf within 1e-4 of that leaf's largest
magnitude; after three steps losses and grad norms within 1e-5 relative,
params and AdamW's moments within 1e-6.  T = 40 is off the chunk of 16.
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

ARCH = "mamba2-2.7b"
B, S = 2, 40
STACKS = {"ssm": {}, "ssm_remat": dict(remat=True), "ssm_tail": dict(block_pattern=("ssm", "ssm"), num_layers=3)}


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
    assert set(tcfg.layer_kinds) == {"ssm"} and S % tcfg.ssm_chunk
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
        assert torch.isfinite(w).all()
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_three_adamw_steps_match_reference():
    """``build_train_step`` (AdamW, the reference's cosine schedule, clip
    1.0) from the reference's initial weights, three batches, against the
    reference's jitted step on an Auto-axis (1, 1) mesh (caveat R2).  The
    SSD block's 1-D leaves (``A_log``, ``D`` and ``dt_bias`` start far
    from 0) are decayed as the reference's stacked (n_superblocks, H)
    leaves are: the port matches the reference's step here (fault C3)."""
    jcfg, tcfg = _configs("ssm")
    lr, total = 3e-4, 10
    bundle = j_build_train_step(jcfg, host_mesh(), JCell("t", S, B, "train"), lr=lr, total_steps=total)
    jstep_fn = bundle.jit()
    jp = bundle.model.init(jax.random.PRNGKey(0))
    jo = j_make_optimizer(jcfg.optimizer, j_cosine(lr, 100, total)).init(jp)
    ts = build_train_step(tcfg, "cpu", ShapeCell("t", S, B, "train"), lr=lr, total_steps=total)
    assert tcfg.optimizer == "adamw"
    tp = _port_leaves(tcfg, jp)
    a_log0 = tp["layers"][0]["ssm"]["A_log"].clone()
    to = ts.optimizer.init(tp)
    jstep, tstep = jnp.int32(0), 0
    for i in range(3):
        tokens = _tokens(jcfg, 10 + i)
        jp, jo, jstep, jm = jstep_fn(jp, jo, jstep, jnp.asarray(tokens))
        tp, to, tstep, tm = ts(tp, to, tstep, torch.from_numpy(tokens))
        assert tstep == int(jstep) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * float(jm[key]), (i, key)
    assert not torch.equal(tp["layers"][0]["ssm"]["A_log"], a_log0)
    for g, w in zip(tree_leaves(tp), tree_leaves(_port_leaves(tcfg, jp))):
        assert float((g - w).abs().max()) <= 1e-6
    for key in ("m", "v"):
        for g, w in zip(tree_leaves(to[key]), tree_leaves(_port_leaves(tcfg, jo[key]))):
            assert float((g - w).abs().max()) <= 1e-6


def test_train_cli_trains_a_mamba2_smoke_stack(capsys, tmp_path):
    from repro_torch.launch import train

    assert train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "24",
                       "--batch", "2", "--ckpt", str(tmp_path)]) == 0
    assert "finished: step 2, loss " in capsys.readouterr().out
