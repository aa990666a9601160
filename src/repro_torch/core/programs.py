"""Request-level control-flow programs: compiled token automata as control
words (the port's own copy of ``repro/core/programs.py``).

The paper's control-flow plane lowers branch/loop structure out of the host
and into configuration the fabric executes autonomously.  The serving-side
analogue of "control flow" is everything a request does that is not flat
left-to-right sampling: grammar/JSON-schema constrained output, literal
tool-call delimiters, fork-and-join multi-continuation sampling.  This module
compiles those request programs down to the same representation every other
plane in this repo uses — small flat int32 tables shipped alongside the
launch (next to ``DecodePlan`` / ``TreePlan`` rows) and interpreted per
token, never per-Python-branch:

* :class:`TokenAutomaton` — a DFA over *token ids*, packed as one flat
  ``(S, V) int32`` transition table (``-1`` = reject) plus an ``(S,)`` accept
  vector.  Grammars are authored at character level (a small JSON-schema
  subset and literal text), compiled to a char DFA, then lifted to token
  level through the tokenizer's token→string map, exactly the move the
  constrained-decoding literature makes; tool-call delimiters may also be
  given directly as literal token-id sequences.
* :class:`RequestProgram` — an automaton plus request-level control flow:
  a fork point (sample K continuations from the one committed prefix) and a
  join/stop policy picking the surviving stream.

Invariants the rest of the stack relies on (and the tests prove):

* **No dead states.**  Every state reachable through the packed table is
  either accepting or has at least one allowed token; constrained greedy
  decode can therefore never paint itself into a corner mid-stream
  (``validate`` enforces this after a backward liveness prune).
* **Determinism.**  ``step`` is a pure table lookup, so automaton state is
  *derived* state: it can be recomputed from the committed token stream at
  any time, which is what makes speculative rollback and crash re-warm
  byte-exact for free — a re-run replays the same transitions.
* **Earliest-accept stop.**  Generation stops the moment the automaton
  enters an accepting state; multi-segment programs chain segments at each
  segment's earliest accept (greedy chaining), keeping the composed machine
  deterministic.

The module is numpy-only (like ``core.pages``) so the fabric can parse
program specs without torch or the model stack; the serve loop keeps each
compiled program's allowed sets on the card as well
(:class:`repro_torch.launch.steps.ProgramTable`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# character-level grammar fragments (Thompson NFA -> DFA)
# ---------------------------------------------------------------------------
# The grammar AST is tiny on purpose: literals, character classes with
# bounded repetition, sequence, and alternation — enough to express the
# JSON-schema subset below with a finite DFA.


class _Nfa:
    """ε-NFA under construction: integer states, char edges, ε edges."""

    def __init__(self):
        self.n = 0
        self.edges: Dict[Tuple[int, str], set] = {}
        self.eps: Dict[int, set] = {}

    def state(self) -> int:
        self.n += 1
        return self.n - 1

    def edge(self, a: int, ch: str, b: int) -> None:
        self.edges.setdefault((a, ch), set()).add(b)

    def eedge(self, a: int, b: int) -> None:
        self.eps.setdefault(a, set()).add(b)


def _frag_lit(nfa: _Nfa, text: str) -> Tuple[int, int]:
    start = nfa.state()
    cur = start
    for ch in text:
        nxt = nfa.state()
        nfa.edge(cur, ch, nxt)
        cur = nxt
    return start, cur


def _frag_class(nfa: _Nfa, chars: str, lo: int, hi: int) -> Tuple[int, int]:
    """Between ``lo`` and ``hi`` repetitions of one char from ``chars``."""
    if hi < lo or lo < 0:
        raise ValueError(f"bad repetition bounds [{lo}, {hi}]")
    start = nfa.state()
    end = nfa.state()
    cur = start
    if lo == 0:
        nfa.eedge(cur, end)
    for i in range(hi):
        nxt = nfa.state()
        for ch in set(chars):
            nfa.edge(cur, ch, nxt)
        if i + 1 >= lo:
            nfa.eedge(nxt, end)
        cur = nxt
    return start, end


def _frag_seq(nfa: _Nfa, frags: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    if not frags:
        s = nfa.state()
        return s, s
    for (_, e), (s2, _) in zip(frags, frags[1:]):
        nfa.eedge(e, s2)
    return frags[0][0], frags[-1][1]


def _frag_alt(nfa: _Nfa, frags: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    start = nfa.state()
    end = nfa.state()
    for s, e in frags:
        nfa.eedge(start, s)
        nfa.eedge(e, end)
    return start, end


def _build_frag(nfa: _Nfa, node: Any) -> Tuple[int, int]:
    """AST node -> NFA fragment.  Nodes are plain tuples:
    ("lit", text) | ("class", chars, lo, hi) | ("seq", [...]) | ("alt", [...])
    """
    kind = node[0]
    if kind == "lit":
        return _frag_lit(nfa, node[1])
    if kind == "class":
        return _frag_class(nfa, node[1], node[2], node[3])
    if kind == "seq":
        return _frag_seq(nfa, [_build_frag(nfa, c) for c in node[1]])
    if kind == "alt":
        return _frag_alt(nfa, [_build_frag(nfa, c) for c in node[1]])
    raise ValueError(f"unknown grammar node {kind!r}")


def _eclose(nfa: _Nfa, states: frozenset) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps.get(s, ()):
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _determinize(nfa: _Nfa, start: int, accept: int):
    """Subset construction -> (char transition dicts, accept flags, start=0)."""
    alphabet = sorted({ch for (_, ch) in nfa.edges})
    init = _eclose(nfa, frozenset([start]))
    index = {init: 0}
    order = [init]
    trans: List[Dict[str, int]] = []
    todo = [init]
    while todo:
        cur = todo.pop(0)
        row: Dict[str, int] = {}
        for ch in alphabet:
            nxt = set()
            for s in cur:
                nxt |= nfa.edges.get((s, ch), set())
            if not nxt:
                continue
            closed = _eclose(nfa, frozenset(nxt))
            if closed not in index:
                index[closed] = len(order)
                order.append(closed)
                todo.append(closed)
            row[ch] = index[closed]
        trans.append(row)
    accepts = [accept in st for st in order]
    return trans, accepts


# ---------------------------------------------------------------------------
# JSON-schema subset -> grammar AST
# ---------------------------------------------------------------------------

_STR_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789_"
_DIGITS = "0123456789"


def schema_to_ast(schema: Dict[str, Any]) -> Any:
    """Compile a small JSON-schema subset to a grammar AST.

    Supported: ``const``, ``enum`` (scalars), ``boolean``, ``integer``
    (``maxDigits``, ``minimum >= 0`` drops the sign), ``string``
    (``minLength``/``maxLength``/``charset``), ``object`` with ``properties``
    serialized in declaration order (all required, no whitespace), and
    ``array`` of a homogeneous ``items`` schema with ``minItems``/
    ``maxItems``.  Bounded repetition everywhere keeps the DFA finite.
    """
    if "const" in schema:
        return ("lit", json.dumps(schema["const"], separators=(",", ":")))
    if "enum" in schema:
        return ("alt", [("lit", json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"]])
    t = schema.get("type")
    if t == "boolean":
        return ("alt", [("lit", "true"), ("lit", "false")])
    if t == "integer":
        digits = int(schema.get("maxDigits", 3))
        body = ("class", _DIGITS, 1, max(digits, 1))
        if schema.get("minimum", -1) >= 0:
            return body
        return ("seq", [("alt", [("lit", ""), ("lit", "-")]), body])
    if t == "string":
        lo = int(schema.get("minLength", 1))
        hi = int(schema.get("maxLength", 4))
        chars = str(schema.get("charset", _STR_CHARS))
        return ("seq", [("lit", '"'), ("class", chars, lo, hi), ("lit", '"')])
    if t == "object":
        props = schema.get("properties", {})
        parts: List[Any] = [("lit", "{")]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts.append(("lit", ","))
            parts.append(("lit", json.dumps(key) + ":"))
            parts.append(schema_to_ast(sub))
        parts.append(("lit", "}"))
        return ("seq", parts)
    if t == "array":
        items = schema.get("items", {"type": "integer"})
        lo = int(schema.get("minItems", 1))
        hi = int(schema.get("maxItems", 3))
        if lo < 1 or hi < lo:
            raise ValueError(f"array bounds [{lo}, {hi}] unsupported")
        item = schema_to_ast(items)
        tail = ("seq", [("lit", ","), item])
        opts = [("seq", [item] + [tail] * k) for k in range(lo - 1, hi)]
        return ("seq", [("lit", "["), ("alt", opts), ("lit", "]")])
    raise ValueError(f"unsupported schema: {schema!r}")


# ---------------------------------------------------------------------------
# the compiled control word
# ---------------------------------------------------------------------------


def default_token_strs(vocab_size: int) -> List[str]:
    """Token→string map for the synthetic serve vocab: token ``t`` is the
    single character ``chr(t)`` (smoke vocabs are byte-sized, so JSON
    punctuation, digits, and letters are all directly addressable)."""
    return [chr(t) for t in range(vocab_size)]


@dataclasses.dataclass(frozen=True)
class TokenAutomaton:
    """A DFA over token ids packed as flat int32 control words.

    ``trans``   (S, V) int32 — next state per (state, token), ``-1`` rejects
    ``accept``  (S,) bool — entering an accepting state STOPS the stream
    ``start``   initial state (before any generated token)
    """

    trans: np.ndarray
    accept: np.ndarray
    start: int = 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_tables(trans: np.ndarray, accept: np.ndarray, start: int = 0
                    ) -> "TokenAutomaton":
        a = TokenAutomaton(
            np.ascontiguousarray(np.asarray(trans, np.int32)),
            np.asarray(accept, bool).copy(), int(start),
        )
        return a._prune().validate()

    @staticmethod
    def from_token_literal(tokens: Sequence[int], vocab_size: int
                           ) -> "TokenAutomaton":
        """Literal token-id sequence (tool-call delimiters): state ``i``
        allows exactly ``tokens[i]``; state ``len(tokens)`` accepts."""
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("empty token literal")
        n = len(toks)
        trans = np.full((n + 1, vocab_size), -1, np.int32)
        for i, t in enumerate(toks):
            trans[i, t] = i + 1
        accept = np.zeros((n + 1,), bool)
        accept[n] = True
        return TokenAutomaton.from_tables(trans, accept)

    @staticmethod
    def from_ast(ast: Any, token_strs: Sequence[str]) -> "TokenAutomaton":
        """Char-level grammar AST -> char DFA -> token-level DFA.

        A token is allowed from a char-DFA state when ALL of its characters
        walk successfully; its destination is the state the walk ends in —
        the standard token-lift from constrained decoding.
        """
        nfa = _Nfa()
        start, end = _build_frag(nfa, ast)
        ctrans, caccept = _determinize(nfa, start, end)
        S, V = len(ctrans), len(token_strs)
        trans = np.full((S, V), -1, np.int32)
        for s, row in enumerate(ctrans):
            for v, text in enumerate(token_strs):
                if not text:
                    continue
                cur: Optional[int] = s
                for ch in text:
                    cur = row.get(ch) if cur == s else ctrans[cur].get(ch)
                    if cur is None:
                        break
                if cur is not None:
                    trans[s, v] = cur
        return TokenAutomaton.from_tables(trans, np.asarray(caccept, bool))

    @staticmethod
    def from_json_schema(schema: Dict[str, Any], token_strs: Sequence[str]
                         ) -> "TokenAutomaton":
        return TokenAutomaton.from_ast(schema_to_ast(schema), token_strs)

    def concat(self, other: "TokenAutomaton") -> "TokenAutomaton":
        """Greedy chaining: the moment this automaton accepts, control moves
        to ``other``'s start state (earliest-accept segment boundary)."""
        S1, V = self.trans.shape
        S2, V2 = other.trans.shape
        if V != V2:
            raise ValueError(f"vocab mismatch {V} != {V2}")
        trans = np.full((S1 + S2, V), -1, np.int32)
        trans[:S1] = self.trans
        trans[S1:] = np.where(other.trans >= 0, other.trans + S1, -1)
        # edges into an accepting state of A are rewired to B's start
        redirect = np.where(self.accept[np.maximum(self.trans, 0)]
                            & (self.trans >= 0),
                            S1 + other.start, trans[:S1])
        trans[:S1] = redirect
        accept = np.concatenate([np.zeros((S1,), bool), other.accept])
        start = self.start if not self.accept[self.start] else S1 + other.start
        return TokenAutomaton.from_tables(trans, accept, start)

    # -- liveness ----------------------------------------------------------
    def _prune(self) -> "TokenAutomaton":
        """Backward liveness prune: cut transitions into states from which
        no accepting state is reachable, so constrained decode never enters
        a dead end.  Raises if the start state itself is dead."""
        S = self.trans.shape[0]
        live = self.accept.copy()
        changed = True
        while changed:
            changed = False
            reaches = (self.trans >= 0) & live[np.maximum(self.trans, 0)]
            new_live = live | reaches.any(axis=1)
            if (new_live != live).any():
                live, changed = new_live, True
        if not live[self.start]:
            raise ValueError("grammar matches no token sequence")
        trans = np.where((self.trans >= 0) & live[np.maximum(self.trans, 0)],
                         self.trans, -1).astype(np.int32)
        return TokenAutomaton(trans, self.accept.copy(), self.start)

    def validate(self) -> "TokenAutomaton":
        """Enforce the no-dead-state invariant on every reachable state."""
        S, V = self.trans.shape
        if self.accept.shape != (S,):
            raise ValueError("accept vector shape mismatch")
        seen = {self.start}
        todo = [self.start]
        while todo:
            s = todo.pop()
            if not self.accept[s] and not (self.trans[s] >= 0).any():
                raise ValueError(f"dead non-accepting state {s}")
            for t in np.unique(self.trans[s]):
                if t >= 0 and int(t) not in seen:
                    seen.add(int(t))
                    todo.append(int(t))
        return self

    # -- execution ---------------------------------------------------------
    @property
    def num_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.trans.shape[1])

    def step(self, state: int, token: int) -> int:
        """-1 stays -1 (sticky reject); otherwise one table lookup."""
        if state < 0:
            return -1
        return int(self.trans[state, int(token)])

    def allowed(self, state: int) -> np.ndarray:
        """Token ids allowed from ``state`` (empty when rejected/accepting)."""
        if state < 0 or self.accept[state]:
            return np.zeros((0,), np.int64)
        return np.nonzero(self.trans[state] >= 0)[0]

    def mask(self, state: int) -> np.ndarray:
        """(V,) bool allowed-set mask for logit masking."""
        if state < 0:
            return np.zeros((self.vocab_size,), bool)
        return self.trans[state] >= 0

    def is_accept(self, state: int) -> bool:
        return state >= 0 and bool(self.accept[state])

    def walk(self, state: int, tokens: Sequence[int]) -> int:
        for t in tokens:
            state = self.step(state, t)
        return state

    def accepts(self, tokens: Sequence[int]) -> bool:
        """True when ``tokens`` is exactly a stream the constrained decoder
        could emit: every prefix transition valid, earliest-accept reached
        exactly at the end."""
        st = self.start
        for i, t in enumerate(tokens):
            if self.is_accept(st):
                return False  # should have stopped earlier
            st = self.step(st, t)
            if st < 0:
                return False
        return self.is_accept(st)

    def tree_states(self, state0: int, toks_row: Sequence[int], parents:
                    Sequence[int]) -> np.ndarray:
        """Per-node automaton states for one draft tree's tokens.

        ``state0`` is the slot state AFTER its last committed token — node 0
        re-feeds that token, so ``A[0] = state0``; node ``t``'s state is its
        parent's advanced by node ``t``'s draft token (-1 once rejected).
        """
        T = len(parents)
        A = np.full((T,), -1, np.int32)
        A[0] = state0
        for t in range(1, T):
            A[t] = self.step(int(A[parents[t]]), int(toks_row[t]))
        return A

    # -- packing / snapshot ------------------------------------------------
    def control_bytes(self) -> int:
        """Bytes of control words a launch would prefetch for this program:
        the flat transition table, the accept vector, and one state word."""
        return self.trans.nbytes + self.accept.shape[0] + 4

    def snapshot(self) -> dict:
        return {
            "trans": [[int(v) for v in row] for row in self.trans],
            "accept": [bool(v) for v in self.accept],
            "start": int(self.start),
        }

    @staticmethod
    def from_snapshot(snap: dict) -> "TokenAutomaton":
        return TokenAutomaton.from_tables(
            np.asarray(snap["trans"], np.int32),
            np.asarray(snap["accept"], bool), int(snap["start"]),
        )


# ---------------------------------------------------------------------------
# request programs: automaton segments + fork/join control flow
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RequestProgram:
    """A compiled request program: the fused segment automaton plus the
    request-level control flow around it.

    ``fork``  K continuations sampled from the one committed prefix (K free
              slots, one shared admission prefill, paged prefix sharing)
    ``join``  "first": the shortest accepted stream wins (ties to the lowest
              branch index) and losers retire early; "all": every branch
              runs to completion and the result carries all streams.
    """

    automaton: TokenAutomaton
    fork: int = 1
    join: str = "first"

    def __post_init__(self):
        if self.fork < 1:
            raise ValueError(f"fork must be >= 1, got {self.fork}")
        if self.join not in ("first", "all"):
            raise ValueError(f"unknown join policy {self.join!r}")


def _compile_segment(seg: Dict[str, Any], token_strs: Sequence[str]
                     ) -> TokenAutomaton:
    kind = seg.get("kind")
    if kind == "literal":
        return TokenAutomaton.from_ast(("lit", str(seg["text"])), token_strs)
    if kind == "tokens":
        return TokenAutomaton.from_token_literal(seg["tokens"], len(token_strs))
    if kind == "json_schema":
        return TokenAutomaton.from_json_schema(seg["schema"], token_strs)
    raise ValueError(f"unknown program segment kind {kind!r}")


def compile_program(spec: Dict[str, Any], vocab_size: int, *,
                    token_strs: Optional[Sequence[str]] = None
                    ) -> RequestProgram:
    """Compile a JSON program spec to a :class:`RequestProgram`.

    Spec shape (all JSON-serializable, so it rides ``Request``/the wire)::

        {"segments": [{"kind": "literal", "text": "CALL("},
                      {"kind": "json_schema", "schema": {...}},
                      {"kind": "tokens", "tokens": [41, 10]}],
         "fork": 2, "join": "first"}
    """
    strs = list(token_strs) if token_strs is not None \
        else default_token_strs(vocab_size)
    segs = spec.get("segments", [])
    if not segs:
        raise ValueError("program spec needs at least one segment")
    auto = _compile_segment(segs[0], strs)
    for seg in segs[1:]:
        auto = auto.concat(_compile_segment(seg, strs))
    return RequestProgram(
        automaton=auto,
        fork=int(spec.get("fork", 1)),
        join=str(spec.get("join", "first")),
    )


def program_slots(spec: Optional[Dict[str, Any]]) -> int:
    """Decode slots a request's program needs (fork width; 1 when flat),
    for the fabric's capacity accounting."""
    if not spec:
        return 1
    return max(int(spec.get("fork", 1)), 1)


def masked_argmax(logits_row: np.ndarray, mask: np.ndarray) -> int:
    """Greedy pick restricted to the allowed set (mask must be nonempty)."""
    if not mask.any():
        raise ValueError("empty allowed-set mask")
    neg = np.finfo(np.float32).min
    return int(np.argmax(np.where(mask, logits_row.astype(np.float32), neg)))


def random_automaton(rng: np.random.Generator, vocab_size: int, *,
                     max_states: int = 6, max_fanout: int = 6
                     ) -> TokenAutomaton:
    """Seeded random DFA for property sweeps.

    Construction guarantees the no-dead-state invariant by wiring a forward
    "spine" edge from every state toward the single accepting state, then
    sprinkling random extra edges; ``from_tables`` re-validates.
    """
    S = int(rng.integers(2, max_states + 1))
    trans = np.full((S, vocab_size), -1, np.int32)
    accept = np.zeros((S,), bool)
    accept[S - 1] = True
    for s in range(S - 1):
        for _ in range(int(rng.integers(1, max_fanout + 1))):
            trans[s, int(rng.integers(0, vocab_size))] = \
                int(rng.integers(0, S))
        # the spine edge lands LAST so no random edge can orphan the accept
        trans[s, int(rng.integers(0, vocab_size))] = s + 1
    return TokenAutomaton.from_tables(trans, accept)
