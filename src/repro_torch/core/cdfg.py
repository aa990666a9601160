"""Control-Data-Flow-Graph program representation (paper §2.1; the port's
own copy of ``repro/core/cdfg.py``, pure Python on the host).

A program is a CFG whose nodes are basic blocks (BBs); each BB embeds a DFG.
The Agile PE Assignment scheduler (:mod:`repro_torch.core.agile`) maps it
onto a fabric of PEs; the same representation describes model super-blocks
(attention / FFN / MoE / recurrent "BBs") for pipeline stage assignment.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class BasicBlock:
    """A basic block: single-entry single-exit DFG.

    n_ops        DFG operator count (PEs needed for a fully spatial mapping)
    depth        DFG critical-path depth (cycles through the block)
    trip_count   relative execution frequency (inner loops execute more)
    loop_level   nesting depth; 0 = outermost
    kind         compute | branch | loop  (the Control Flow Sender's operator
                 modes: DFG / branch / loop)
    ii           initiation interval of the block's pipeline (>=1)
    parallel     iterations are independent (can replicate the BB pipeline);
                 False for loop-carried dependences (paper: FFT/Viterbi II=2,
                 LDPC inter-loop deps limit Agile Assignment)
    """

    name: str
    n_ops: int
    depth: int = 1
    trip_count: float = 1.0
    loop_level: int = 0
    kind: str = "compute"
    ii: int = 1
    parallel: bool = True

    @property
    def work(self) -> float:
        """Total dynamic work: ops x frequency."""
        return self.n_ops * self.trip_count


# Edge kinds: seq | branch_taken | branch_not_taken | loop_back | loop_exit
Edge = Tuple[str, str, str]


@dataclass
class CDFG:
    name: str
    blocks: List[BasicBlock] = field(default_factory=list)
    edges: List[Edge] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_name: Dict[str, BasicBlock] = {b.name: b for b in self.blocks}
        if len(self._by_name) != len(self.blocks):
            raise ValueError(f"duplicate BB names in CDFG {self.name}")
        for src, dst, kind in self.edges:
            if src not in self._by_name or dst not in self._by_name:
                raise ValueError(f"edge ({src},{dst}) references unknown BB")
            if kind not in ("seq", "branch_taken", "branch_not_taken", "loop_back", "loop_exit"):
                raise ValueError(f"bad edge kind {kind}")

    def block(self, name: str) -> BasicBlock:
        return self._by_name[name]

    def successors(self, name: str) -> List[Tuple[BasicBlock, str]]:
        return [(self._by_name[d], k) for s, d, k in self.edges if s == name]

    def predecessors(self, name: str) -> List[Tuple[BasicBlock, str]]:
        return [(self._by_name[s], k) for s, d, k in self.edges if d == name]

    @property
    def n_ops(self) -> int:
        return sum(b.n_ops for b in self.blocks)

    @property
    def total_work(self) -> float:
        return sum(b.work for b in self.blocks)

    def loop_levels(self) -> Dict[int, List[BasicBlock]]:
        out: Dict[int, List[BasicBlock]] = {}
        for b in self.blocks:
            out.setdefault(b.loop_level, []).append(b)
        return out

    def branch_blocks(self) -> List[BasicBlock]:
        return [b for b in self.blocks if b.kind == "branch"]

    def validate(self) -> None:
        """Structural sanity: branch BBs have taken+not-taken successors, etc."""
        for b in self.branch_blocks():
            kinds = {k for _, k in self.successors(b.name)}
            if not {"branch_taken", "branch_not_taken"} <= kinds:
                raise ValueError(f"branch BB {b.name} lacks taken/not-taken edges")
