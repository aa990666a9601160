"""PyTorch port, the model registry: every arch the reference registers,
held against it on the CPU with the reference's weights bridged through
numpy.

Gates:

* ``repro_torch.configs.list_archs()`` equals the reference's, and every
  arch's ``FULL`` and smoke config equals the reference's field by field;
* for each arch the port added last (Llama-4-Maverick, Qwen1.5-4B with QKV
  bias, Qwen3-32B with qk-norm, StableLM-12B, StarCoder2-3B, Phi-3-Vision
  and MusicGen with their frontend stubs), prefill and decode-plane logits
  at smoke size within 1e-5 (f32) of the reference's and greedy ids equal,
  for 3 launches of 2 tokens;
* narrow depth-2 stacks at head dims 96 and 160 (d_model 192 and 320 over 2
  heads: Phi-3-Vision's and StableLM-12B's head dims) take the same gate,
  so the plain paths run at the two head dims the attention kernels gained.
"""
from __future__ import annotations

import dataclasses

import pytest

from _torch_arch_cases import compare_logits
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs import list_archs as j_archs
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import list_archs as t_archs

NEW_ARCHS = ("llama4-maverick-400b-a17b", "qwen1.5-4b", "qwen3-32b", "stablelm-12b", "starcoder2-3b",
             "phi-3-vision-4.2b", "musicgen-large")


def test_registry_equals_the_reference():
    assert t_archs() == j_archs()
    assert set(NEW_ARCHS) <= set(t_archs()) and len(t_archs()) == 10


def test_shape_cells_equal_the_reference():
    from repro.configs import SHAPE_CELLS as j_cells
    from repro_torch.configs import SHAPE_CELLS as t_cells

    assert {n: dataclasses.asdict(c) for n, c in t_cells.items()} == {
        n: dataclasses.asdict(c) for n, c in j_cells.items()}


@pytest.mark.parametrize("arch", j_archs())
def test_full_and_smoke_configs_equal_the_reference(arch):
    assert dataclasses.asdict(t_full(arch)) == dataclasses.asdict(j_full(arch))
    assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch))


def test_attention_options_are_covered():
    """qkv_bias (Qwen1.5, StarCoder2) and qk_norm (Qwen3-32B) are among the
    arches the logits test runs, as are G = 1 (MHA) and a top-1 shared-expert
    MoE."""
    cfgs = [t_smoke(a) for a in NEW_ARCHS]
    assert any(c.qkv_bias for c in cfgs) and any(c.qk_norm for c in cfgs)
    assert any(c.num_heads == c.num_kv_heads for c in cfgs)
    assert any(c.top_k == 1 and c.num_shared_experts == 1 for c in cfgs)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_plane_logits_match_reference(arch):
    kw = dict(decode_plane=True)
    jcfg, tcfg = dataclasses.replace(j_smoke(arch), **kw), dataclasses.replace(t_smoke(arch), **kw)
    compare_logits(jcfg, tcfg, frontend=bool(tcfg.frontend))


@pytest.mark.parametrize("arch,d_model,hd", [("phi-3-vision-4.2b", 192, 96), ("stablelm-12b", 320, 160)])
def test_head_dims_96_and_160_match_reference(arch, d_model, hd):
    kw = dict(decode_plane=True, d_model=d_model, num_heads=2, num_kv_heads=2 if hd == 96 else 1)
    jcfg, tcfg = dataclasses.replace(j_smoke(arch), **kw), dataclasses.replace(t_smoke(arch), **kw)
    assert tcfg.resolved_head_dim == hd and tcfg.num_layers == 2
    compare_logits(jcfg, tcfg, frontend=bool(tcfg.frontend))
