"""Control-plane "configuration" tensors (port of ``repro/core/plans.py``).

Small integer tensors that fully determine what the data plane does:
which expert processes which token slot (:class:`DispatchPlan`), which
expert each decode token runs (:class:`DecodePlan`, carried in the KV
cache), and which draft token attends to which cache rows
(:class:`TreePlan`).

Control-word invariants (the contracts every consumer relies on):

* **Plan-row carry** — a :class:`DecodePlan` consumed at decode launch
  ``t`` was computed at launch ``t-1`` (prefill seeds ``t=0``); with
  ``spec_tokens > 1`` the cache carries one plan row per draft position and
  the verifier's ``prev_accept`` selects which row the next launch's token 0
  consumes.
* **Topological node order** — :class:`TreePlan` node ids satisfy
  ``parents[t] < t``, so the per-token length vector ``base + t + 1`` stays
  a correct clamp for the ancestor-masked attention kernel.
* **Length-clamp contract** — no control word may direct the data plane past
  a sequence's valid cache prefix.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class DispatchPlan(NamedTuple):
    """Static-shape MoE dispatch configuration for T tokens.

    dispatch_idx   (E, C) int32   token feeding each expert slot; T = padding
    dispatch_valid (E, C) bool    slot occupied?
    combine_idx    (T, k) int32   flat slot (e*C + c) per assignment; -1 = dropped
    combine_w      (T, k) f32     router weight per assignment (0 if dropped)

    Flat views emitted once by ``make_dispatch_plan`` (the words the fused
    MoE kernels read):

    flat_idx       (E*C,) int32   token feeding each flat slot; T = empty slot
    slot_w         (E*C,) f32     combine weight of the slot's assignment
    flat_cidx      (T*k,) int32   flat slot per assignment; E*C = dropped
    flat_cw        (T*k,) f32     weight per assignment (0 = dropped)
    """

    dispatch_idx: torch.Tensor
    dispatch_valid: torch.Tensor
    combine_idx: torch.Tensor
    combine_w: torch.Tensor
    flat_idx: Optional[torch.Tensor] = None
    slot_w: Optional[torch.Tensor] = None
    flat_cidx: Optional[torch.Tensor] = None
    flat_cw: Optional[torch.Tensor] = None

    @property
    def num_experts(self) -> int:
        return self.dispatch_idx.shape[0]

    @property
    def capacity(self) -> int:
        return self.dispatch_idx.shape[1]

    def flat_dispatch_idx(self) -> torch.Tensor:
        """(E*C,) int32 token feeding each slot; T = empty."""
        if self.flat_idx is not None:
            return self.flat_idx
        T = self.combine_idx.shape[0]
        full = torch.full_like(self.dispatch_idx, T)
        return torch.where(self.dispatch_valid, self.dispatch_idx, full).reshape(-1).to(torch.int32)

    def flat_combine_words(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """((T*k,) int32 slot per assignment with E*C = dropped, (T*k,) f32 weight)."""
        if self.flat_cidx is not None and self.flat_cw is not None:
            return self.flat_cidx, self.flat_cw
        E, C = self.dispatch_idx.shape
        dump = torch.full_like(self.combine_idx, E * C)
        cidx = torch.where(self.combine_idx >= 0, self.combine_idx, dump).reshape(-1).to(torch.int32)
        return cidx, self.combine_w.reshape(-1).to(torch.float32)

    def flat_slot_w(self) -> torch.Tensor:
        """(E*C,) f32 combine weight of the assignment occupying each slot."""
        if self.slot_w is not None:
            return self.slot_w
        E, C = self.dispatch_idx.shape
        cidx, cw = self.flat_combine_words()
        out = torch.zeros((E * C + 1,), dtype=torch.float32, device=cw.device)
        out[cidx.long()] = cw
        return out[:-1]


class DecodePlan(NamedTuple):
    """Capacity-free MoE configuration for T decode tokens.

    expert_ids  (T, k) int32  expert per assignment
    weights     (T, k) f32    renormalized router weight per assignment

    The fields may carry extra leading axes ((B, T, k) for a batch of
    drafts); :meth:`flatten` merges them to the (T_total, k) layout the
    single-launch kernel consumes.
    """

    expert_ids: torch.Tensor
    weights: torch.Tensor

    def flatten(self) -> "DecodePlan":
        """Merge leading axes to the kernel's (T_total, k) control layout."""
        k = self.expert_ids.shape[-1]
        return DecodePlan(self.expert_ids.reshape(-1, k), self.weights.reshape(-1, k))


class TreePlan(NamedTuple):
    """Compiled draft-tree topology for one speculative launch.

    ``parents[t]`` is node ``t``'s parent (``parents[0] == -1``: the root is
    the last accepted token); node ids are topologically ordered.  This slice
    serves chains (``TreePlan.chain(T)``); branchy trees ride the same
    ancestor words in a later slice.
    """

    parents: Tuple[int, ...]

    @classmethod
    def chain(cls, num_nodes: int) -> "TreePlan":
        """The degenerate tree: a linear draft of ``num_nodes`` tokens."""
        return cls(tuple(range(-1, num_nodes - 1)))

    @classmethod
    def from_branching(cls, branching: Sequence[int]) -> "TreePlan":
        """Spine-with-siblings topology from per-depth branching factors:
        ``branching[d]`` children hang off the depth-``d`` spine node and the
        first child continues the spine."""
        parents = [-1]
        spine = 0
        for width in branching:
            if width < 1:
                raise ValueError(f"branching factors must be >= 1, got {branching}")
            first = len(parents)
            parents.extend([spine] * width)
            spine = first
        return cls(tuple(parents))

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    def validate(self) -> "TreePlan":
        T = self.num_nodes
        if T < 1 or self.parents[0] != -1:
            raise ValueError(f"node 0 must be the root (parent -1), got {self.parents}")
        if any(not (0 <= self.parents[t] < t) for t in range(1, T)):
            raise ValueError(f"parents must be topologically ordered: {self.parents}")
        if T > 31:
            raise ValueError(
                f"draft trees are limited to 31 nodes (int32 ancestor bitmask), got {T}"
            )
        return self

    def is_chain(self) -> bool:
        return all(p == t - 1 for t, p in enumerate(self.parents))

    def depths(self) -> Tuple[int, ...]:
        """Depth of each node = its rotary-position offset from the base."""
        d = [0] * self.num_nodes
        for t in range(1, self.num_nodes):
            d[t] = d[self.parents[t]] + 1
        return tuple(d)

    def children(self) -> Tuple[Tuple[int, ...], ...]:
        """Children of each node, in node-id (drafter-rank) order."""
        out: list = [[] for _ in range(self.num_nodes)]
        for t in range(1, self.num_nodes):
            out[self.parents[t]].append(t)
        return tuple(tuple(c) for c in out)

    def ancestor_words(self) -> Tuple[int, ...]:
        """Per-node int32 ancestor bitmask (bit u set iff u is on t's root
        path, self included): the word the flash-decode kernel tests."""
        self.validate()
        words = [1]
        for t in range(1, self.num_nodes):
            words.append(words[self.parents[t]] | (1 << t))
        return tuple(words)
