"""PyTorch port, training MoE stacks: the loss and every gradient leaf
against the JAX reference's ``jax.value_and_grad(Model.forward_train)``
(whose MoE layers run jnp dispatch -> local_experts_fn -> combine, the
plan's combine weights carrying the gradient into the router), three steps
of ``build_train_step`` with Adafactor (Qwen3-MoE's own optimizer; its
factored moments of the 3-D expert stacks held too) against the
reference's jitted step, and a Trainer run against the reference Trainer.
CPU only: kernels 3/4 and their backward run their plain versions.

Gates (those of ``tests/test_torch_train_step.py``): the loss within 1e-5
relative, every gradient leaf within 1e-4 of that leaf's largest
magnitude; after three steps losses within 1e-5 relative, params and
optimizer state within 1e-6.  Stacks: Qwen3-MoE smoke under lookahead
routing (also under remat, where ``route_src`` crosses each checkpointed
super-block), under sync, with a capacity factor that drops assignments,
under dense routing, and Llama-4 (top-1 + shared expert).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_cases import bridge, host_mesh, patch_check_rep
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeCell as JCell
from repro.launch.steps import build_train_step as j_build_train_step
from repro.models.model import Model as JModel
from repro.optim import cosine_schedule as j_cosine
from repro.optim import make_optimizer as j_make_optimizer
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.bridge import leaves_from_params
from repro_torch.configs import ShapeCell
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.control_plane import capacity_for
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model as TModel
from repro_torch.optim import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig

QWEN = "qwen3-moe-235b-a22b"
B, S = 2, 16
STACKS = {
    "lookahead": (QWEN, {}),
    "lookahead_remat": (QWEN, dict(remat=True)),
    "sync": (QWEN, dict(route_mode="sync")),
    "drops": (QWEN, dict(capacity_factor=0.5)),
    "dense": (QWEN, dict(route_mode="dense")),
    "llama4": ("llama4-maverick-400b-a17b", {}),
}


def _configs(stack):
    arch, extra = STACKS[stack]
    return dataclasses.replace(j_smoke(arch), **extra), dataclasses.replace(t_smoke(arch), **extra)


def _tokens(cfg, seed, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _port_leaves(tcfg, jtree) -> dict:
    return params_from_numpy(tcfg, bridge(jtree), "cpu", train=True)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_loss_and_gradients_match_reference(stack):
    jcfg, tcfg = _configs(stack)
    if stack == "drops":
        assert capacity_for(B * S, tcfg.num_experts, tcfg.top_k, tcfg.capacity_factor) * tcfg.num_experts \
            < B * S * tcfg.top_k, "the capacity must drop assignments"
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
    assert sorted(tmet) == sorted(jmet) == ["ce", "lb_loss", "loss", "z_loss"]
    for name in jmet:
        assert abs(float(tmet[name].detach()) - float(jmet[name])) <= 1e-5 * max(abs(float(jmet[name])), 1e-30), name
    want = tree_leaves(_port_leaves(tcfg, jgrads))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    routers = [g for g, (n, _) in zip(grads, _named(tp)) if n.endswith("router")]
    assert routers and all(float(g.abs().max()) > 0 for g in routers)


def _named(tree, prefix=""):
    """(dotted name, leaf) in tree_leaves order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("stack", ["lookahead", "llama4"])
def test_three_adafactor_steps_match_reference(stack, monkeypatch):
    """``build_train_step`` (the config's Adafactor, the reference's cosine
    schedule, clip 1.0) from the reference's initial weights, three batches,
    against the reference's jitted step on an Auto-axis (1, 1) mesh (caveat
    R2; its MoE layers through the expert-parallel apply, with the
    ``check_rep`` shim, R3): losses, grad norms, params and the factored
    moments."""
    patch_check_rep(monkeypatch)
    jcfg, tcfg = _configs(stack)
    assert tcfg.optimizer == "adafactor"
    lr, total = 3e-4, 10
    bundle = j_build_train_step(jcfg, host_mesh(), JCell("t", S, B, "train"), lr=lr, total_steps=total)
    jstep_fn = bundle.jit()
    jp = bundle.model.init(jax.random.PRNGKey(0))
    jo = j_make_optimizer(jcfg.optimizer, j_cosine(lr, 100, total)).init(jp)
    ts = build_train_step(tcfg, "cpu", ShapeCell("t", S, B, "train"), lr=lr, total_steps=total)
    tp = _port_leaves(tcfg, jp)
    to = ts.optimizer.init(tp)
    jstep, tstep = jnp.int32(0), 0
    for i in range(3):
        tokens = _tokens(jcfg, 10 + i)
        jp, jo, jstep, jm = jstep_fn(jp, jo, jstep, jnp.asarray(tokens))
        tp, to, tstep, tm = ts(tp, to, tstep, torch.from_numpy(tokens))
        assert tstep == int(jstep) == i + 1
        for key in ("loss", "grad_norm", "lb_loss", "z_loss"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), (i, key)
    for g, w in zip(tree_leaves(tp), tree_leaves(_port_leaves(tcfg, jp))):
        assert float((g - w).abs().max()) <= 1e-6
    # the factored moments under the reference's names and stacked shapes: the 3-D expert stacks' (E, d) /
    # (E, f) row and column means a layer, the stacked norms' one row mean a layer and one column mean
    got = {n: make().numpy() for n, make in leaves_from_params(tcfg, to)}
    want = bridge(jo)
    assert sorted(got) == sorted(want)
    assert got["blocks/scan/b0/moe/w_down/vr"].ndim == 3 and got["blocks/scan/b0/ln1/vc"].ndim == 1
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6, err_msg=name)


def test_trainer_losses_match_the_reference_trainer(tmp_path, monkeypatch):
    """A Qwen3-MoE smoke stack through the port's Trainer (checkpoints every
    2 steps, 4 steps) against the reference Trainer from the same initial
    weights: every loss within 1e-5 relative; the checkpoint's leaf names
    (params and Adafactor's factored moments) equal the reference's."""
    patch_check_rep(monkeypatch)
    jcfg, tcfg = _configs("lookahead")
    arrays = bridge(JModel(jcfg).init(jax.random.PRNGKey(0)))
    steps, every, seq, batch = 4, 2, 16, 2
    port = Trainer(tcfg, ShapeCell("smoke", seq, batch, "train"), "cpu",
                   TrainerConfig(num_steps=steps, checkpoint_every=every, checkpoint_dir=str(tmp_path / "port"),
                                 log_every=100),
                   init_params=lambda: params_from_numpy(tcfg, arrays, "cpu", train=True)).run()
    ref = JTrainer(jcfg, JCell("smoke", seq, batch, "train"), host_mesh(),
                   JTrainerConfig(num_steps=steps, checkpoint_every=every, checkpoint_dir=str(tmp_path / "ref"),
                                  log_every=100)).run()
    got = [(m["step"], m["loss"]) for m in port["metrics"]]
    want = [(m["step"], m["loss"]) for m in ref["metrics"]]
    assert [s for s, _ in got] == [s for s, _ in want] and len(got) == steps
    for (s, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (s, a, b)
    names = []
    for d in (tmp_path / "port", tmp_path / "ref"):
        man = json.loads((d / f"step_{steps:08d}" / "manifest.json").read_text())
        names.append((sorted(r["name"] for r in man["params"]), sorted(r["name"] for r in man["opt_state"])))
    assert names[0] == names[1]
    assert any("router" in n for n in names[0][0]) and any(n.endswith("/vr") for n in names[0][1])


def test_train_cli_trains_a_moe_smoke_stack(capsys, tmp_path):
    from repro_torch.launch import train

    assert train.main(["--arch", QWEN, "--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                       "--batch", "2", "--ckpt", str(tmp_path)]) == 0
    assert "finished: step 2, loss " in capsys.readouterr().out
