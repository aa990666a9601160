"""Speculative-decode drafters and verify rule (port of the reference's
``launch/speculative.py`` without request-program guides).

The verify rule is greedy: position 0 of a launch is the model's own next
token (always accepted); a draft node stays accepted while its token equals
what the model emitted for its parent.  A chain is the degenerate tree, so
one walk (:func:`greedy_accept_tree`) serves both.  The host drafters
(``repeat``, ``ngram``) are numpy only; :class:`ModelDrafter` drafts with a
small model through the same decode plane.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.control_plane import _top_k
from repro_torch.core.plans import TreePlan
from repro_torch.launch.steps import build_spec_serve_step


def greedy_accept(draft_row, verified_row, width: int, budget: int) -> int:
    """Accepted-token count for one sequence's chain launch.

    draft_row     (T,) the launched tokens (index 0 = last accepted token)
    verified_row  (T,) argmax of the launch logits (successor per position)
    width         T, the speculative width
    budget        remaining tokens this sequence may still emit (>= 1)
    """
    a = 1
    while a < width and a < budget and int(draft_row[a]) == int(verified_row[a - 1]):
        a += 1
    return a


def greedy_accept_tree(draft_row, verified_row, tree: TreePlan, budget: int) -> List[int]:
    """Greedy tree verification: the accepted root path, as node indices.

    Walk from the root, descend into the first child drafted with exactly
    the model's emission for the current node, stop when none matches or
    the budget is spent.  For a chain ``len(path) == greedy_accept(...)``."""
    kids = tree.children()
    path = [0]
    cur = 0
    while len(path) < budget:
        want = int(verified_row[cur])
        nxt = next((c for c in kids[cur] if int(draft_row[c]) == want), None)
        if nxt is None:
            break
        path.append(nxt)
        cur = nxt
    return path


def _followers(history: Sequence[int], tok: int, limit: int) -> List[int]:
    """Distinct tokens that followed ``tok`` in history, most recent first."""
    out: List[int] = []
    for i in range(len(history) - 2, -1, -1):
        if history[i] == tok and history[i + 1] not in out:
            out.append(history[i + 1])
            if len(out) >= limit:
                break
    return out


def draft_tree_repeat(history, last_tok: int, tree: TreePlan) -> List[int]:
    """Every node repeats the last accepted token."""
    return [int(last_tok)] * tree.num_nodes


def draft_tree_ngram(history, last_tok: int, tree: TreePlan) -> List[int]:
    """Bigram-lookup drafter: each node's children are the distinct tokens
    that followed the node's token in history (most recent first; slots
    beyond the evidence repeat the parent token)."""
    toks = [0] * tree.num_nodes
    toks[0] = int(last_tok)
    for node, children in enumerate(tree.children()):
        if not children:
            continue
        cand = _followers(history, toks[node], len(children))
        for rank, child in enumerate(children):
            toks[child] = cand[rank] if rank < len(cand) else toks[node]
    return toks


TREE_DRAFTERS = {"repeat": draft_tree_repeat, "ngram": draft_tree_ngram}


class ModelDrafter:
    """A small draft model proposing top-k branching drafts, batched through
    the same decode plane the target model serves on.

    The drafter owns a contiguous slot-pool cache (it never shares pages
    with the target's pool), admits prompts by prefilling into a slot, and
    keeps itself synchronized with the *accepted* token stream by replaying
    missed tokens through batched width-1 ``decode_tokens`` launches.
    :meth:`propose` then runs one batched launch per tree depth: the spine
    follows the draft model's argmax, siblings take the next-ranked logits.
    Ranks are taken on the model's device by a stable descending sort
    (:func:`repro_torch.core.control_plane._top_k`), so only the (B, k) ids
    cross to the host; they equal the reference's ``np.argsort(-logits)``
    wherever the k-th and (k+1)-th logits differ, and ties break by the
    lower index (numpy's unstable sort leaves their order undefined).
    Every launch goes through a compiled step
    (:func:`repro_torch.launch.steps.build_spec_serve_step`, a CUDA graph on
    the card) in the pool ``graphs``.

    Draft rows written during ``propose`` are scratch: positions at or past
    a slot's committed length are re-fed (or overwritten) before they are
    ever attended (the length-clamp contract).
    """

    def __init__(self, model, params, slots: int, max_len: int, *, graphs=None):
        self.model, self.params = model, params
        self.cache = model.init_cache(slots, max_len)
        self._step = build_spec_serve_step(model, params, self.cache, batch=slots, max_len=max_len, graphs=graphs)
        self.fed = np.zeros((slots,), np.int32)  # cache rows holding real tokens
        self.pending: List[List[int]] = [[] for _ in range(slots)]
        self.launches = 0  # width-1 decode launches (catch-up and drafting)

    def admit(self, slot: int, prompt) -> None:
        """Prefill the admitted prompt into the drafter's slot."""
        self.model.prefill(self.params, np.asarray(prompt)[None], self.cache, slot=slot)
        self.fed[slot] = len(prompt)
        self.pending[slot] = []

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        """Queue accepted tokens (rows ``fed..`` of the true stream) for
        replay; called by the serve loop after each verify."""
        self.pending[slot].extend(int(t) for t in tokens)

    def _advance(self, toks, lens):
        """One width-1 launch; its (B, V) logits, left on the device."""
        logits = self._step.launch(np.asarray(toks)[:, None], lens)[0]
        self.launches += 1
        return logits[:, 0]

    def catch_up(self) -> None:
        """Replay queued accepted tokens, batched across slots; slots with
        nothing pending park their step at the scratch row ``fed[b]``."""
        B = len(self.pending)
        while any(self.pending):
            toks = np.zeros((B,), np.int32)
            lens = self.fed.copy()
            adv = np.zeros((B,), np.int32)
            for b in range(B):
                if self.pending[b]:
                    toks[b] = self.pending[b].pop(0)
                    adv[b] = 1
            self._advance(toks, lens)
            self.fed = self.fed + adv

    def propose(self, last_tok, lengths, tree: TreePlan) -> np.ndarray:
        """(B,) last accepted tokens + committed lengths -> (B, T) tree
        tokens: children of the spine node at depth d get the draft model's
        top-``len(children)`` tokens, the first child (the spine) continues
        from the top-1."""
        B = len(last_tok)
        kids = tree.children()
        toks = np.zeros((B, tree.num_nodes), np.int32)
        toks[:, 0] = last_tok
        cur = np.asarray(last_tok, np.int32).copy()
        pos = np.asarray(lengths, np.int32).copy()
        for node in tree.spine():
            children = kids[node]
            if not children:
                break
            top = _top_k(self._advance(cur, pos), len(children))[1].cpu().numpy()
            for rank, child in enumerate(children):
                toks[:, child] = top[:, rank]
            cur = top[:, 0].astype(np.int32)
            pos += 1
        return toks
