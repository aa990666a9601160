"""PyTorch port, sharding rules: ``spec_for_param``, ``param_pspecs``,
``batch_spec``, ``data_axes`` and ``cache_spec_for`` give the reference's
specs (a ``PartitionSpec`` read as a tuple) for every leaf of the
reference's own parameter and cache trees, on duck-typed meshes of the
production shapes ``(16, 16)`` and ``(2, 16, 16)`` and on small ones; and
``shard_params`` leaves each rank exactly its 1/ep share of the expert
bytes.  Integer specs: exactly equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.parallel import sharding as JS
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as TS


class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape``."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {
    "16x16": dict(data=16, model=16), "2x16x16": dict(pod=2, data=16, model=16),
    "1x1": dict(data=1, model=1), "2x4": dict(data=2, model=4), "1x3": dict(data=1, model=3),
}
ARCHS = ["qwen3-moe-235b-a22b", "recurrentgemma-2b", "mamba2-2.7b", "qwen3-32b", "llama4-maverick-400b-a17b",
         "phi-3-vision-4.2b"]


def _names(path):
    out = []
    for k in path:
        out.append(str(k.key) if hasattr(k, "key") else getattr(k, "idx", getattr(k, "name", None)))
    return tuple(out)


def _flat(tree):
    return {_names(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nest(flat):
    """The flat {names: leaf} map as nested dicts (the port's rules walk any
    dict/list tree and read only the names)."""
    out: dict = {}
    for names, leaf in flat.items():
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = leaf
    return out


def _port_flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_flat(v, path + (k,))
    else:
        yield path, tree


def _abstract_params(cfg):
    return jax.eval_shape(lambda k: JT.init_params(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    fm = FakeMesh(**MESHES[mesh])
    abstract = _abstract_params(j_config(arch))
    flat = _flat(abstract)
    want = {k: tuple(v) for k, v in _flat(JS.param_pspecs(abstract, fm)).items()}
    got = dict(_port_flat(TS.param_pspecs(_nest(flat), fm)))
    assert got == want
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        assert TS.spec_for_param(_names(path), leaf.shape, fm) == tuple(JS.spec_for_param(path, leaf.shape, fm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_spec_and_data_axes_match_reference(mesh):
    fm = FakeMesh(**MESHES[mesh])
    assert TS.data_axes(fm) == JS.data_axes(fm)
    for batch in (1, 2, 3, 4, 16, 32, 64, 96):
        for extra in (0, 1, 2):
            assert TS.batch_spec(batch, fm, extra) == tuple(JS.batch_spec(batch, fm, extra)), (batch, extra)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x4"])
@pytest.mark.parametrize("arch,kw", [
    ("qwen3-moe-235b-a22b", dict(decode_plane=True, spec_tokens=4)),
    ("qwen3-moe-235b-a22b", dict(decode_plane=True, paged=True)),
    ("recurrentgemma-2b", dict(decode_plane=True)),
    ("mamba2-2.7b", dict(decode_plane=True)),
])
def test_cache_specs_match_reference(arch, kw, mesh):
    fm = FakeMesh(**MESHES[mesh])
    cfg = dataclasses.replace(j_config(arch), **kw)
    for batch in (1, 32):
        abstract = jax.eval_shape(lambda: JT.init_cache(cfg, batch, 64))
        for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
            want = tuple(JS.cache_spec_for(path, leaf.shape, batch, fm))
            assert TS.cache_spec_for(_names(path), leaf.shape, batch, fm) == want, _names(path)


def test_moe_param_specs_match_reference():
    from repro.parallel.moe_parallel import _moe_param_specs as j_specs
    from repro_torch.parallel.moe_parallel import _moe_param_specs as t_specs

    p = jax.eval_shape(lambda k: JT.init_params(k, j_smoke("llama4-maverick-400b-a17b")),
                       jax.ShapeDtypeStruct((2,), jnp.uint32))
    moe_p = next(v["moe"] for k, v in _nest(_flat(p))["blocks"]["scan"].items() if "moe" in v)
    want = jax.tree_util.tree_map(tuple, j_specs(moe_p), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert t_specs(moe_p) == want


@pytest.mark.parametrize("ep", [1, 2, 4, 8])
def test_shard_params_leaves_each_rank_its_expert_slice(ep):
    cfg = dataclasses.replace(t_smoke("qwen3-moe-235b-a22b"), num_shared_experts=1)
    params = Model(cfg, device="cpu").init(0)
    full = dict(_port_flat({"p": params["layers"][0]}))
    expert = {k for k in full if k[-1] in ("w_gate", "w_up", "w_down") and "shared" not in k}
    assert len(expert) == 3
    # one rule: the leaves cut are those the specs put on 'model' along their expert axis
    assert {k for k, v in full.items() if TS.is_expert_stack(k, tuple(v.shape))} == expert
    total = sum(full[k].numel() * full[k].element_size() for k in expert)
    got_bytes = 0
    for r in range(ep):
        mesh = Mesh({"data": 1, "model": ep}, {"data": 0, "model": r}, {}, torch.device("cpu"))
        placed = TS.shard_params(params, cfg, mesh)
        flat = dict(_port_flat({"p": placed["layers"][0]}))
        for k, v in flat.items():
            if k in expert:
                e_loc = cfg.num_experts // ep
                assert v.shape[0] == e_loc
                assert torch.equal(v, full[k][r * e_loc:(r + 1) * e_loc])
                got_bytes += v.untyped_storage().nbytes()
            else:
                assert v is full[k], k
        assert placed["embed"] is params["embed"]
    assert got_bytes == total
    if ep > 1:
        with pytest.raises(ValueError, match="not divisible"):
            TS.shard_params(params, dataclasses.replace(cfg, num_experts=ep * 2 + 1),
                            Mesh({"data": 1, "model": ep}, {"data": 0, "model": 0}, {}, torch.device("cpu")))


@pytest.mark.parametrize("ep", [2, 4])
def test_model_init_draws_each_rank_its_expert_slice(ep):
    """A model bound to a rank's expert slice draws the same weights as the
    whole model and keeps that rank's share of the stacks: bitwise
    ``shard_params`` of the whole draw."""
    cfg = dataclasses.replace(t_smoke("qwen3-moe-235b-a22b"), num_shared_experts=1)
    full = Model(cfg, device="cpu").init(0)
    for r in range(ep):
        mesh = Mesh({"data": 1, "model": ep}, {"data": 0, "model": r}, {}, torch.device("cpu"))
        got = Model(cfg, device="cpu", experts=TS.expert_slice(cfg, mesh)).init(0)
        want = TS.shard_params(full, cfg, mesh)
        got = dict(_port_flat({**got, "layers": dict(enumerate(got["layers"]))}))
        want = dict(_port_flat({**want, "layers": dict(enumerate(want["layers"]))}))
        assert any(v.shape[0] == cfg.num_experts // ep for k, v in want.items() if k[-1] == "w_down")
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
