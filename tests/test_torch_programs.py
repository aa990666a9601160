"""PyTorch port, request programs: compiled token automata steering
constrained decode, held against the JAX reference.

The automaton layer (``repro_torch.core.programs``, the port's own copy)
must compile every spec to the reference's tables, and the host verify and
drafting rules (``accept_tree_program``, ``steer_tree_tokens``,
``tree_states``) must equal the reference's on the same automata and
trees.  Then the served streams: chain speculation through the port's
``ServeFabric``, the paged int8 tree with an injected crash and a
checkpoint re-warm, and the steered model drafter must each be
token-identical to the reference model's masked sequential oracle (the
reference weights bridged into the port), with no masked emission.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import programs as jp
from repro.core.plans import TreePlan as JTreePlan
from repro.launch import speculative as jspec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.plans import TreePlan
from repro_torch.core.programs import (
    TokenAutomaton,
    compile_program,
    default_token_strs,
    masked_argmax,
    program_slots,
    random_automaton,
)
from repro_torch.launch import serve as tserve
from repro_torch.launch.speculative import accept_tree_program, steer_tree_tokens
from repro_torch.runtime.fabric import FabricConfig, ServeFabric
from repro_torch.runtime.faults import FaultInjector, parse_faults

from tests._torch_program_cases import (
    MAX_LEN,
    SPEC,
    WIDTH,
    bridged,
    configs,
    drain,
    host_mesh,
    j_request,
    masked_oracle,
    requests,
    shim_check_rep,
)

V = 256  # smoke vocab: token t <-> chr(t), so JSON punctuation is addressable


def _chars(text: str) -> list:
    return [ord(c) for c in text]


# ---------------------------------------------------------------------------
# automata: the reference's tables, spec for spec
# ---------------------------------------------------------------------------

SPECS = {
    "object": SPEC,
    "object2": {"segments": [{"kind": "json_schema", "schema": {"type": "object", "properties": {
        "a": {"type": "integer", "maxDigits": 2}, "b": {"type": "boolean"}}}}]},
    "enum_fork": {"fork": 3, "join": "first", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42, 99]}}]},
    "const_string": {"segments": [{"kind": "json_schema", "schema": {"const": "ok"}},
                                  {"kind": "json_schema", "schema": {"type": "string", "minLength": 1,
                                                                     "maxLength": 3, "charset": "ab"}}]},
    "array_signed": {"segments": [{"kind": "json_schema", "schema": {"type": "array", "items": {"type": "integer",
                                                                                                "maxDigits": 2},
                                                                     "minItems": 1, "maxItems": 3}}]},
    "tool_call": {"fork": 2, "join": "all", "segments": [{"kind": "literal", "text": "CALL("},
                                                          {"kind": "json_schema", "schema": {"enum": ["x", "yz"]}},
                                                          {"kind": "tokens", "tokens": [41, 10]}]},
}


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("vocab", [256, 1000])
def test_compile_program_equals_reference(name, vocab):
    mine, ref = compile_program(SPECS[name], vocab), jp.compile_program(SPECS[name], vocab)
    assert np.array_equal(mine.automaton.trans, ref.automaton.trans)
    assert np.array_equal(mine.automaton.accept, ref.automaton.accept)
    assert mine.automaton.start == ref.automaton.start
    assert (mine.fork, mine.join) == (ref.fork, ref.join)
    assert program_slots(SPECS[name]) == jp.program_slots(SPECS[name])
    assert mine.automaton.control_bytes() == ref.automaton.control_bytes()


@pytest.mark.parametrize("branching", [(2, 2), (2, 1), (3,), (1, 1, 1)])
def test_host_rules_equal_reference_on_random_automata(branching):
    """tree_states, steer_tree_tokens and accept_tree_program give the
    reference's answers on the same seeded automata, drafts and trees."""
    tree, jtree = TreePlan.from_branching(list(branching)).validate(), JTreePlan.from_branching(list(branching))
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(40):
        auto, jauto = random_automaton(rng, 24), jp.random_automaton(jrng, 24)
        assert np.array_equal(auto.trans, jauto.trans) and np.array_equal(auto.accept, jauto.accept)
        draft = rng.integers(0, 24, size=tree.num_nodes).astype(np.int32)
        verified = rng.integers(0, 24, size=tree.num_nodes).astype(np.int32)
        jrng.integers(0, 24, size=tree.num_nodes), jrng.integers(0, 24, size=tree.num_nodes)
        hist = list(rng.integers(0, 24, size=12))
        jrng.integers(0, 24, size=12)
        for st in {auto.start, int(auto.trans[auto.start].max())}:
            assert np.array_equal(auto.tree_states(st, draft, tree.parents), jauto.tree_states(st, draft, jtree.parents))
            assert np.array_equal(steer_tree_tokens(draft, tree, auto, st, hist),
                                  jspec.steer_tree_tokens(draft, jtree, jauto, st, hist))
            for budget in (1, 2, tree.num_nodes):
                assert accept_tree_program(draft, verified, tree, budget, auto, st) == \
                    jspec.accept_tree_program(draft, verified, jtree, budget, jauto, st)


# ---------------------------------------------------------------------------
# automaton construction: schema subset, literals, concat
# ---------------------------------------------------------------------------


def test_json_schema_object_walks_and_accepts():
    auto = TokenAutomaton.from_json_schema(SPECS["object2"]["segments"][0]["schema"], default_token_strs(V))
    assert auto.accepts(_chars('{"a":7,"b":true}'))
    assert auto.accepts(_chars('{"a":42,"b":false}'))
    assert not auto.accepts(_chars('{"a":7}'))          # missing property
    assert not auto.accepts(_chars('{"a":777,"b":true}'))  # 3 digits
    assert not auto.accepts(_chars('{"b":true,"a":7}'))    # declaration order
    assert not auto.accepts(_chars('{"a":7,"b":true}}'))   # past the accept


@pytest.mark.parametrize("schema,good,bad", [
    ({"enum": ["yes", "no"]}, ['"yes"', '"no"'], ['"maybe"']),
    ({"const": 17}, ["17"], ["18"]),
    ({"type": "string", "minLength": 1, "maxLength": 2, "charset": "ab"}, ['"a"', '"ab"'], ['""', '"abc"']),
    ({"type": "array", "items": {"type": "boolean"}, "minItems": 1, "maxItems": 2}, ["[true]", "[true,false]"],
     ["[]"]),
    ({"type": "integer", "maxDigits": 2}, ["-7", "5"], ["--7", "42"]),  # earliest accept: "4" ends it
])
def test_enum_const_string_array_integer_schemas(schema, good, bad):
    auto = TokenAutomaton.from_json_schema(schema, default_token_strs(V))
    assert all(auto.accepts(_chars(t)) for t in good)
    assert not any(auto.accepts(_chars(t)) for t in bad)


def test_literal_concat_chains_at_earliest_accept():
    a = TokenAutomaton.from_token_literal(_chars("<t>"), V)
    b = TokenAutomaton.from_token_literal(_chars("</t>"), V)
    ab = a.concat(b)
    assert ab.accepts(_chars("<t></t>"))
    assert not ab.accepts(_chars("<t>"))
    st = ab.walk(ab.start, _chars("<t></t>"))
    assert ab.is_accept(st) and ab.allowed(st).size == 0


@pytest.mark.parametrize("spec", [
    {"segments": [{"kind": "meteor"}]},
    {"fork": 0, "segments": [{"kind": "literal", "text": "a"}]},
    {"join": "sideways", "segments": [{"kind": "literal", "text": "a"}]},
    {"segments": []},
])
def test_compile_program_spec_validation(spec):
    with pytest.raises(ValueError):
        compile_program(spec, V)
    with pytest.raises(ValueError):
        jp.compile_program(spec, V)


def test_program_slots_and_snapshot_roundtrip():
    spec = {"segments": [{"kind": "literal", "text": "ab"}]}
    prog = compile_program(spec, V)
    assert prog.fork == 1 and prog.automaton.accepts(_chars("ab"))
    assert program_slots(spec) == 1 and program_slots(None) == 1
    assert program_slots({"fork": 3, "segments": []}) == 3
    auto = TokenAutomaton.from_json_schema({"enum": [10, 20]}, default_token_strs(V))
    back = TokenAutomaton.from_snapshot(auto.snapshot())
    assert np.array_equal(back.trans, auto.trans) and np.array_equal(back.accept, auto.accept)
    assert back.start == auto.start
    assert auto.control_bytes() == auto.trans.nbytes + auto.accept.shape[0] + 4


def test_random_automata_no_masked_emission_and_grammar_acceptance():
    """Over 200 random automata: masked argmax emissions stay allowed, no
    visited state is dead, finished streams are accepted, and replaying a
    stream lands on the same state."""
    rng = np.random.default_rng(0)
    vocab, finished = 24, 0
    for trial in range(200):
        auto = random_automaton(rng, vocab)
        st, stream = auto.start, []
        for _ in range(64):
            if auto.is_accept(st):
                break
            assert auto.allowed(st).size > 0, f"trial {trial}: dead state {st}"
            tok = masked_argmax(rng.standard_normal(vocab).astype(np.float32), auto.mask(st))
            assert int(auto.trans[st, tok]) >= 0
            stream.append(tok)
            st = auto.step(st, tok)
        if auto.is_accept(st):
            finished += 1
            assert auto.accepts(stream)
        assert auto.walk(auto.start, stream) == st
    assert finished >= 150


def test_steer_tree_tokens_only_proposes_allowed():
    rng = np.random.default_rng(2)
    tree = TreePlan.from_branching([2, 2]).validate()
    kids = tree.children()
    for _ in range(50):
        auto = random_automaton(rng, 24)
        steered = steer_tree_tokens(rng.integers(0, 24, size=tree.num_nodes).astype(np.int32), tree, auto,
                                    auto.start)
        A = auto.tree_states(auto.start, steered, tree.parents)
        for t in range(1, tree.num_nodes):
            p = int(tree.parents[t])
            if A[p] >= 0 and not auto.is_accept(A[p]):
                assert int(auto.trans[A[p], int(steered[t])]) >= 0
        for p, cs in enumerate(kids):  # live siblings never duplicate each other
            if A[p] >= 0 and not auto.is_accept(A[p]) and len(cs) > 1 and len(auto.allowed(A[p])) >= len(cs):
                assert len({int(steered[c]) for c in cs}) == len(cs)


# ---------------------------------------------------------------------------
# served streams against the reference's masked sequential oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env():
    cfg_j, cfg = configs(decode_plane=True, spec_tokens=WIDTH)
    params_j, params = bridged(cfg_j, cfg)
    reqs = requests(cfg.vocab_size, SPEC)
    return dict(cfg_j=cfg_j, cfg=cfg, params_j=params_j, params=params, requests=reqs,
                oracle=masked_oracle(cfg_j, params_j, reqs, SPEC, MAX_LEN))


def _run_fabric(cfg, params, reqs, *, tree=None, specs="", ckpt=None, checkpoint_every=0, slots=2):
    inj = FaultInjector(parse_faults(specs)) if specs else None
    ladder = tserve.degrade_ladder(tree, tree.num_nodes if tree is not None else cfg.spec_tokens)
    make = tserve.make_replica_factory(cfg, slots, MAX_LEN, params, ladder, fault_hook=inj.check if inj else None,
                                       launch_timeout=30.0, device="cpu")
    fabric = ServeFabric(
        make, list(reqs),
        FabricConfig(n_replicas=1, launch_timeout=30.0, checkpoint_every=checkpoint_every,
                     max_degrade_level=len(ladder) - 1, synthetic_step_times=True),
        ckpt=ckpt, restore_params=(lambda mgr: mgr.restore("cpu")[0]) if ckpt else None, params=params)
    return fabric.run(), fabric.stats


def _assert_token_identical(results, oracle, reqs):
    for req in reqs:
        res = results[req.rid]
        assert res.error is None, f"rid {req.rid} errored: {res.error}"
        assert res.tokens == oracle[req.rid], f"rid {req.rid}: {res.tokens} != masked oracle {oracle[req.rid]}"


def test_constrained_chain_matches_masked_oracle(env):
    results, stats = _run_fabric(env["cfg"], env["params"], env["requests"])
    _assert_token_identical(results, env["oracle"], env["requests"])
    assert stats["prog_masked_emissions"] == 0
    assert stats["prog_tokens"] > 0 and stats["prog_states_visited"] > 0 and stats["prog_mask_cnt"] > 0
    assert stats["prog_mask_frac_sum"] / stats["prog_mask_cnt"] > 0.5
    auto = compile_program(SPEC, env["cfg"].vocab_size).automaton
    for req in env["requests"]:
        toks = results[req.rid].tokens
        if len(toks) < req.gen + 1:  # finished before the budget ran out
            assert auto.accepts(toks)


def test_constrained_tree_paged_int8_crash_matches_masked_oracle(env, tmp_path):
    """ACCEPTANCE: tree drafts + paged KV + int8 KV/experts + one injected
    crash and a checkpoint re-warm through the port's fabric: streams are
    token-identical to the reference's masked sequential oracle on the
    same quantized weights."""
    tree = TreePlan.from_branching([2]).validate()
    cq_j, cq = configs(decode_plane=True, spec_tokens=WIDTH, paged=True, page_size=4, kv_dtype="int8",
                       expert_dtype="int8")
    params_j, params = bridged(cq_j, cq)
    reqs = requests(cq.vocab_size, SPEC)
    ckpt = CheckpointManager(tmp_path / "prog", keep=2, cfg=cq)
    results, stats = _run_fabric(cq, params, reqs, tree=tree, specs="crash@step=3", ckpt=ckpt, checkpoint_every=2)
    assert stats["crashes"] == 1 and stats["rejoins"] == 1 and stats["restores"] >= 1
    assert stats["rewarm_prefills"] >= 1
    assert stats["dropped"] == 0 and stats["duplicates"] == 0
    assert stats["prog_masked_emissions"] == 0
    _assert_token_identical(results, masked_oracle(cq_j, params_j, reqs, SPEC, MAX_LEN), reqs)


def test_steered_drafter_never_changes_a_committed_token(env):
    """Steering repeat/ngram drafts by the allowed set changes no committed
    token and accepts at least as many tokens a launch as unsteered."""
    tree = TreePlan.from_branching([2]).validate()
    rates, streams = {}, {}
    for steer in (True, False):
        rep = tserve.ServeReplica(env["cfg"], 2, MAX_LEN, env["params"], tree=tree, steer_drafter=steer, device="cpu")
        results = drain(rep, env["requests"])
        assert rep.prog_masked_emissions == 0
        rates[steer] = rep.accepted_total / max(rep.launches, 1)
        streams[steer] = {rid: r.tokens for rid, r in results.items()}
    assert streams[True] == streams[False] == env["oracle"]
    assert rates[True] >= rates[False], rates


def test_model_drafter_guided_by_automaton_matches_reference(env, monkeypatch):
    """The 1-layer draft model's logits are ranked on the model's device
    among the allowed tokens per spine depth: streams equal the masked oracle and
    the reference replica's, and so do the accept counts (its drafts are
    the reference's wherever no two logits tie)."""
    from repro.launch.serve import ServeReplica as JReplica

    shim_check_rep(monkeypatch)
    reqs = requests(env["cfg"].vocab_size, SPEC, n=2)
    rep_j = JReplica(env["cfg_j"], host_mesh(), 2, MAX_LEN, env["params_j"], drafter="model")
    want = drain(rep_j, reqs, j_request)
    dcfg_j = dataclasses.replace(env["cfg_j"], num_layers=1, spec_tokens=1, paged=False)
    dcfg = dataclasses.replace(env["cfg"], num_layers=1, spec_tokens=1, paged=False)
    _, dparams = bridged(dcfg_j, dcfg, key=7)
    rep = tserve.ServeReplica(env["cfg"], 2, MAX_LEN, env["params"], drafter="model", drafter_params=dparams,
                              device="cpu")
    got = drain(rep, reqs)
    assert rep.prog_masked_emissions == 0
    oracle = masked_oracle(env["cfg_j"], env["params_j"], reqs, SPEC, MAX_LEN)
    assert {rid: r.tokens for rid, r in got.items()} == {rid: r.tokens for rid, r in want.items()} == oracle
    assert (rep.accepted_total, rep.drafted_total) == (rep_j.accepted_total, rep_j.drafted_total)
    assert rep.prog_tokens == rep_j.prog_tokens and rep.prog_mask_cnt == rep_j.prog_mask_cnt
    assert rep.prog_states_seen == rep_j.prog_states_seen
    assert rep.prog_mask_frac_sum == pytest.approx(rep_j.prog_mask_frac_sum, rel=1e-12)
    assert rep.verify_launches > 0


def test_programmed_replica_snapshot_and_reset(env):
    """The ledger records each programmed slot's automaton state; a drained
    replica resets its program counters and keeps its compiled programs."""
    rep = tserve.ServeReplica(env["cfg"], 2, MAX_LEN, env["params"], device="cpu")
    rep.admit(env["requests"][0])
    meta = rep.snapshot_meta()
    assert meta["rids"] == [0] and meta["programs"]["0"]["state"] == int(rep.prog_state[0])
    assert [r.rid for r in rep.in_flight()] == [0]
    drain(rep, [])
    assert rep.prog_tokens > 0 and len(rep.compile_s) == 1
    rep.reset()
    assert rep.prog_tokens == 0 and rep.prog_mask_cnt == 0 and not rep.prog_states_seen
    assert len(rep._prog_cache) == 1 and (rep.prog_rows[0] >= 0).any()


def test_unconstrained_launches_read_back_only_the_ids(env, monkeypatch):
    """Without a programmed slot the masked verify never runs: the launch's
    ids are the only read back."""
    from repro_torch.launch import serve as serve_mod

    calls = []
    monkeypatch.setattr(serve_mod, "masked_argmax_rows", lambda *a: calls.append(a))
    reqs = [dataclasses.replace(r, program=None) for r in env["requests"]]
    rep = tserve.ServeReplica(env["cfg"], 2, MAX_LEN, env["params"], device="cpu")
    drain(rep, reqs)
    assert rep.launches > 0 and rep.verify_launches == 0 and not calls
    assert rep.prog_tokens == 0
