"""Host-side speculative-decode bookkeeping (copy of the reference's
``launch/speculative.py`` verify rule and host drafters; numpy only).

The verify rule is greedy: position 0 of a launch is the model's own next
token (always accepted); a draft node stays accepted while its token equals
what the model emitted for its parent.  A chain is the degenerate tree, so
one walk (:func:`greedy_accept_tree`) serves both.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.plans import TreePlan


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
