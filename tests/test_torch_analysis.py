"""PyTorch port, the analytic cost model and the host-only dry run
(``repro_torch.launch.analysis``, ``repro_torch.launch.dryrun``), on the CPU:

* ``analytic_memory_bytes``, ``model_flops`` and ``roofline`` equal the
  reference's (``repro.launch.analysis``, which imports no jax) for every
  arch, every cell of ``cells_for`` and the meshes (16, 16), (2, 16, 16),
  (2, 4) and (1, 1); ``roofline`` with the reference module's peaks
  replaced by the card's for the comparison, key for key at 1e-12;
* ``step_flops`` equals the count ``chip_smoke.train_cell`` made by hand
  before it moved here, for its four training cells;
* ``collective_bytes`` and the dry run's per-rank argument bytes equal
  what 4 spawned gloo ranks at (2, 2) issue and hold: a recorder around
  ``torch.distributed``'s collectives (installed here only) counts each
  op and its result bytes over one ``tp`` train step (Qwen3-MoE smoke,
  the a2a body, Adafactor), one ``fsdp`` step (StarCoder2 smoke, AdamW),
  each also under remat (a layer's gathers again in the recompute, which
  checkpoint's early stop ends before the a2a body's output gather), and
  one decode launch of a ``ServeReplica`` on the mesh (the MoE
  layers' sums over ``model`` and the verified ids over ``data``);
* ``run_cell`` gives ``ok`` for every arch, cell and pod count, and
  ``skipped`` exactly where the reference's cells skip; ``--list`` prints
  what the reference's ``--list`` prints.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_expert_parallel import run_ranks

REPO = Path(__file__).resolve().parent.parent
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 4},
          {"data": 1, "model": 1})
REL = 1e-12


def _archs():
    from repro_torch.configs import list_archs

    return list_archs()


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, str):
        assert a == b, path
    else:
        assert abs(a - b) <= REL * max(abs(a), abs(b)), (path, a, b)


@pytest.mark.parametrize("arch", _archs())
def test_cost_model_equals_the_reference(arch, monkeypatch):
    import repro.launch.analysis as ja
    from repro.configs import cells_for as j_cells
    from repro.configs import get_config as j_config

    from repro_torch.configs import cells_for, get_config
    from repro_torch.launch import analysis as ta

    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ja, name, getattr(ta, name))
    cfg, jcfg = get_config(arch), j_config(arch)
    assert [c.name for c in cells_for(cfg)] == [c.name for c in j_cells(jcfg)]
    for cell, jcell in zip(cells_for(cfg), j_cells(jcfg)):
        assert cfg.num_active_params() == jcfg.num_active_params()
        assert ta.model_flops(cfg, cell) == ja.model_flops(jcfg, jcell)
        for shape in MESHES:
            n_dev = int(np.prod(list(shape.values())))
            n_model, n_data = shape["model"], n_dev // shape["model"]
            assert ta.analytic_memory_bytes(cfg, cell, n_model, n_data) == \
                ja.analytic_memory_bytes(jcfg, jcell, n_model, n_data)
            cost = {"flops": ta.step_flops(cfg, cell) / n_dev, "bytes accessed": 1.0e9}
            coll = ta.collective_bytes(cfg, cell, shape)
            got = ta.roofline(cost, coll, cfg, cell, n_dev, mesh_shape=shape)
            want = ja.roofline(cost, coll, jcfg, jcell, n_dev, mesh_shape=shape)
            _close(got, want)
            assert got["bottleneck"] in ("compute_s", "memory_s", "collective_s")


def test_reference_analysis_imports_no_jax():
    code = "import sys, repro.launch.analysis; assert 'jax' not in sys.modules, sorted(sys.modules)"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=60)


# chip_smoke.train_cell's hand count before it moved to step_flops:
# 6 N_matmul B S + 3 * 4 B pairs nq hd n_attn (+ 3 B n_ssm ssd_work's FLOPs)
TRAIN_CELLS = {
    "train_full_width": ("starcoder2-3b", 20, 4, 145038998765568.0),
    "train_moe_full_width": ("qwen3-moe-235b-a22b", 2, 2, 27071581519872.0),
    "train_rec_full_width": ("recurrentgemma-2b", None, 2, 66364542812160.0),
    "train_ssm_full_width": ("mamba2-2.7b", None, 2, 70234996211712.0),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CELLS))
def test_step_flops_is_train_cells_hand_count(name):
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.analysis import step_flops

    arch, layers, batch, want = TRAIN_CELLS[name]
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    assert step_flops(cfg, ShapeCell(name, 2048, batch, "train")) == want


# ---------------------------------------------------------------------------
# against 4 gloo ranks at (2, 2)
# ---------------------------------------------------------------------------

SHAPE = {"data": 2, "model": 2}
# name -> (arch, strategy, batch, seq, remat)
TRAIN = {"tp": ("qwen3-moe-235b-a22b", "tp", 4, 16, False), "fsdp": ("starcoder2-3b", "fsdp", 4, 16, False),
         "tp_remat": ("qwen3-moe-235b-a22b", "tp", 4, 16, True),
         "fsdp_remat": ("starcoder2-3b", "fsdp", 4, 16, True)}
DEC_SLOTS, DEC_T, DEC_PROMPT, DEC_GEN = 4, 2, 8, 6
_OPS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


class Recorder:
    """Counts and result bytes of every collective issued through
    ``torch.distributed`` while installed (the result: the reduced
    tensor, the gathered or scattered output)."""

    def __init__(self):
        self.per_op = {op: {"count": 0, "result_bytes": 0} for op in _OPS.values()}
        self.orig = {}

    def __enter__(self):
        import torch.distributed as dist

        def wrap(fn, op):
            def call(*args, **kw):
                t = args[0]
                self.per_op[op]["count"] += 1
                self.per_op[op]["result_bytes"] += t.numel() * t.element_size()
                return fn(*args, **kw)
            return call

        for name, op in _OPS.items():
            self.orig[name] = getattr(dist, name)
            setattr(dist, name, wrap(self.orig[name], op))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self.orig.items():
            setattr(dist, name, fn)


def _rank_counts(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.parallel.collectives import tree_bytes

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, "cpu")
        out = {}
        for name, (arch, strategy, batch, seq, remat) in TRAIN.items():
            cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
            step = build_train_step(cfg, mesh, ShapeCell("t", seq, batch, "train"), strategy=strategy)
            params = step.shard(step.model.init(0, train=True))
            opt = step.optimizer.init(params)
            tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq))
            with Recorder() as rec:
                step(params, opt, 0, tokens)
            out[name] = {"per_op": rec.per_op, "bytes": tree_bytes(params) + tree_bytes(opt)}
        cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), decode_plane=True, spec_tokens=DEC_T)
        max_len = DEC_PROMPT + DEC_GEN + DEC_T
        rep = serve.ServeReplica(cfg, DEC_SLOTS, max_len, serve.build_model(cfg, mesh, DEC_SLOTS).init(0),
                                 mesh=mesh)
        for req in serve.synthetic_requests(cfg.vocab_size, DEC_PROMPT, DEC_GEN, DEC_SLOTS):
            rep.admit(req)
        with Recorder() as rec:
            rep.step()
        out["decode"] = {"per_op": rec.per_op, "cache_rows": [int(c["k"].shape[0]) for c in rep.cache]}
        (d / f"counts{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("analysis_ranks")
    run_ranks(_rank_counts, 4, d, timeout=240)
    return [json.loads((d / f"counts{r}.json").read_text()) for r in range(4)]


def _issued(coll):
    return {op: {"count": v["count"], "result_bytes": v["result_bytes"]} for op, v in coll["per_op"].items()
            if op != "collective-permute"}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_collective_bytes_equal_a_train_steps_on_4_ranks(rank_counts, name):
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.analysis import collective_bytes

    arch, strategy, batch, seq, remat = TRAIN[name]
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    want = collective_bytes(cfg, ShapeCell("t", seq, batch, "train"), SHAPE, strategy)
    assert want["wire_bytes"] > 0 and 0 < want["control_share"] <= 1
    for rank, got in enumerate(rank_counts):
        assert got[name]["per_op"] == _issued(want), (name, rank)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_dryrun_argument_bytes_equal_what_each_rank_holds(rank_counts, name):
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.analysis import shape_mesh
    from repro_torch.launch.dryrun import argument_bytes

    arch, strategy, batch, seq, _ = TRAIN[name]
    want = argument_bytes(get_smoke_config(arch), ShapeCell("t", seq, batch, "train"), shape_mesh(SHAPE), strategy)
    assert [got[name]["bytes"] for got in rank_counts] == [want] * 4


def test_collective_bytes_equal_a_decode_launch_on_4_ranks(rank_counts):
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.analysis import collective_bytes

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), decode_plane=True, spec_tokens=DEC_T)
    want = collective_bytes(cfg, ShapeCell("d", DEC_PROMPT + DEC_GEN + DEC_T, DEC_SLOTS, "decode"), SHAPE)
    issued = _issued(want)
    assert issued["all-reduce"]["count"] == cfg.num_layers and issued["all-gather"]["count"] == 1
    assert want["control_wire_bytes"] == want["wire_bytes"]  # every word is small or an integer
    for rank, got in enumerate(rank_counts):
        assert got["decode"]["per_op"] == issued, rank
        assert got["decode"]["cache_rows"] == [DEC_SLOTS // 2] * cfg.num_layers  # the rank's own slots


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", _archs())
def test_run_cell_is_ok_or_skipped_where_the_reference_skips(arch, tmp_path):
    from repro.configs import cells_for as j_cells
    from repro.configs import get_config as j_config

    from repro_torch.configs import SHAPE_CELLS
    from repro_torch.launch.dryrun import run_cell

    ref = {c.name for c in j_cells(j_config(arch))}
    for name in SHAPE_CELLS:
        for multi_pod in (False, True):
            rec = run_cell(arch, name, multi_pod, tmp_path)
            if name not in ref:
                assert rec["status"] == "skipped", rec
                continue
            assert rec["status"] == "ok", rec.get("traceback")
            tag = f"{arch}__{name}__{'pod2' if multi_pod else 'pod1'}.json"
            saved = json.loads((tmp_path / tag).read_text())
            assert saved["twin_extrapolation"] is None and saved["n_devices"] == (512 if multi_pod else 256)
            assert saved["memory"]["argument_size_in_bytes"] > 0 and saved["cost"]["flops"] > 0
            assert saved["roofline"]["bottleneck"] in ("compute_s", "memory_s", "collective_s")


def test_list_prints_what_the_reference_prints():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = lambda mod: subprocess.run([sys.executable, "-m", mod, "--list"], capture_output=True, text=True,  # noqa: E731
                                     env=env, timeout=120, check=True).stdout
    assert run("repro_torch.launch.dryrun") == run("repro.launch.dryrun")
