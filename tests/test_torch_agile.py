"""PyTorch port, the host-only planning modules (``core/cdfg.py``,
``core/agile.py``, ``parallel/pipeline.py``: the paper's Agile PE
Assignment) against the JAX package's on the CPU: ``block_costs_for_model``,
``assign_stages``, ``naive_stage_plan``, ``estimate_1f1b`` and
``plan_pipeline`` equal, field for field, for every arch of
``list_archs()`` at two sequence lengths and 1 to 4 stages;
``time_extend_mapping`` and ``static_spatial_mapping`` equal on the CDFGs
``tests/test_agile.py`` draws (and a few fixed ones), and ``assign_stages``
on its cost lists (``tests/test_torch_imports.py`` holds that the port's
modules import nothing of JAX).  Pure Python on both sides: equality is
exact.
"""
from __future__ import annotations

import dataclasses

import pytest

pytest.importorskip("hypothesis", reason="property-based tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_config
from repro.core import agile as j_agile
from repro.core import cdfg as j_cdfg
from repro.parallel import pipeline as j_pipeline
from repro_torch.configs import get_config as t_config
from repro_torch.configs import list_archs
from repro_torch.core import agile as t_agile
from repro_torch.core import cdfg as t_cdfg
from repro_torch.parallel import pipeline as t_pipeline

SEQ_LENS = (512, 4096)


def _fields(x):
    """A result as plain data: dataclasses by field, NamedTuples as tuples."""
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_fields(v) for v in x)
    return x


@pytest.mark.parametrize("arch", list_archs())
def test_block_costs_and_stage_plans_match_reference(arch):
    for S in SEQ_LENS:
        want = j_agile.block_costs_for_model(j_config(arch), S)
        got = t_agile.block_costs_for_model(t_config(arch), S)
        assert got == want
        costs = [c for _, c in got]
        for stages in range(1, 5):
            assert tuple(t_agile.assign_stages(costs, stages)) == tuple(j_agile.assign_stages(costs, stages))
            naive = t_pipeline.naive_stage_plan(costs, stages)
            assert tuple(naive) == tuple(j_pipeline.naive_stage_plan(costs, stages))
            assert naive.ii == j_pipeline.naive_stage_plan(costs, stages).ii
            for m in (1, 8):
                assert _fields(t_pipeline.estimate_1f1b(naive, m)) == _fields(
                    j_pipeline.estimate_1f1b(j_pipeline.naive_stage_plan(costs, stages), m))
            for m in (4, 8):
                got_p = t_pipeline.plan_pipeline(t_config(arch), S, stages, m)
                want_p = j_pipeline.plan_pipeline(j_config(arch), S, stages, m)
                assert _fields(got_p) == _fields(want_p)
                assert got_p["agile"].plan.ii <= got_p["naive"].plan.ii + 1e-9


def test_assign_stages_edge_cases_match_reference():
    for costs, stages in (([], 3), ([5.0], 4), ([1.0, 2.0], 2), ([3.0, 1.0, 1.0, 3.0], 3)):
        assert tuple(t_agile.assign_stages(costs, stages)) == tuple(j_agile.assign_stages(costs, stages))
    for mod in (t_agile, j_agile):
        with pytest.raises(ValueError, match="positive"):
            mod.assign_stages([1.0], 0)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0.1, 100.0), min_size=1, max_size=9), st.integers(1, 4))
def test_assign_stages_matches_reference_on_drawn_costs(costs, s):
    assert tuple(t_agile.assign_stages(costs, s)) == tuple(j_agile.assign_stages(costs, s))


def _block_specs(draw):
    n = draw(st.integers(1, 5))
    return [dict(name=f"bb{i}", n_ops=draw(st.integers(1, 12)), depth=draw(st.integers(1, 6)),
                 trip_count=float(draw(st.integers(1, 1000))), loop_level=i % 3, ii=draw(st.integers(1, 2)),
                 parallel=draw(st.booleans())) for i in range(n)]


block_specs = st.composite(_block_specs)


def _pair(specs, edges=()):
    return (t_cdfg.CDFG("t", [t_cdfg.BasicBlock(**s) for s in specs], list(edges)),
            j_cdfg.CDFG("t", [j_cdfg.BasicBlock(**s) for s in specs], list(edges)))


@settings(max_examples=40, deadline=None)
@given(block_specs(), st.integers(6, 32))
def test_mappings_match_reference_on_drawn_cdfgs(specs, n_pes):
    t, j = _pair(specs)
    if n_pes < len(specs):
        for mod, g in ((t_agile, t), (j_agile, j)):
            with pytest.raises(ValueError, match="one per BB"):
                mod.time_extend_mapping(g, n_pes)
    else:
        assert _fields(t_agile.time_extend_mapping(t, n_pes)) == _fields(j_agile.time_extend_mapping(j, n_pes))
    assert _fields(t_agile.static_spatial_mapping(t, n_pes)) == _fields(j_agile.static_spatial_mapping(j, n_pes))
    assert (t.n_ops, t.total_work) == (j.n_ops, j.total_work)


def test_cdfg_structure_matches_reference():
    specs = [dict(name="entry", n_ops=4), dict(name="br", n_ops=2, kind="branch"),
             dict(name="body", n_ops=9, trip_count=64.0, loop_level=1, kind="loop", parallel=False),
             dict(name="exit", n_ops=3)]
    edges = [("entry", "br", "seq"), ("br", "body", "branch_taken"), ("br", "exit", "branch_not_taken"),
             ("body", "body", "loop_back"), ("body", "exit", "loop_exit")]
    t, j = _pair(specs, edges)
    t.validate()
    j.validate()
    assert [b.name for b, _ in t.successors("br")] == [b.name for b, _ in j.successors("br")]
    assert [k for _, k in t.predecessors("exit")] == [k for _, k in j.predecessors("exit")]
    assert {k: [b.name for b in v] for k, v in t.loop_levels().items()} == {
        k: [b.name for b in v] for k, v in j.loop_levels().items()}
    for n_pes in (8, 18, 40):
        assert _fields(t_agile.time_extend_mapping(t, n_pes)) == _fields(j_agile.time_extend_mapping(j, n_pes))
    for bad in ([("entry", "nowhere", "seq")], [("entry", "br", "jump")]):
        for mod in (t_cdfg, j_cdfg):
            with pytest.raises(ValueError):
                mod.CDFG("bad", [mod.BasicBlock(**s) for s in specs], bad)
    broken = [e for e in edges if e[2] != "branch_not_taken"]
    for mod in (t_cdfg, j_cdfg):
        with pytest.raises(ValueError, match="taken"):
            mod.CDFG("b", [mod.BasicBlock(**s) for s in specs], broken).validate()

