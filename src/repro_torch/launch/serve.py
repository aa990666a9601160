"""Serving driver of the port: continuous-batching replicas with chain or
tree speculation on the Agile decode plane, over a contiguous or a paged KV
cache, over rolling-window caches (chains, and on the paged plane draft
trees) and RG-LRU state for the hybrid RecurrentGemma family, or over SSD
state for the Mamba-2 family, both at spec width 1, for every arch of the
registry (dense, MoE with top-1 routing and a shared expert, and the
vision / audio frontend stubs), with request programs (constrained
decode, fork/join), behind the in-process fault-tolerant fabric or across
worker processes (port of ``repro/launch/serve.py``).

Each :meth:`ServeReplica.step` runs ``spec_tokens`` tokens (or tree nodes)
for every slot in ONE model call, a compiled launch (on the card one CUDA
graph, replayed: :mod:`repro_torch.launch.steps`); between launches the
host verifies each slot's draft greedily (rejected cache rows are
overwritten by the next launch; the plan row the next launch consumes is
selected by ``prev_accept``) and buffers accepted tokens per request until
the request completes.

Trees (``tree=``): the verifier walks the tree and the accepted root path is
committed: on a contiguous cache by ``Model.commit_tree_path`` (compiled
as :class:`repro_torch.launch.steps.TreeCommit`) before lengths advance
(one commit per launch), on the paged plane by commit maps
from the pre-accept lengths that ride the NEXT launch (no commit of its
own).  Paged plane (``cfg.paged``): a :class:`PageTable` of per-slot block
tables and a :class:`PrefixTrie` sharing full prompt pages across
admissions; admission binds pages and writes only the rows it owns.
Rolling buffers and recurrent state stay unpaged there; the commit maps
move a rolling tree's accepted rows mod W.  A frontend arch's admission
passes the reference's zero frontend input (1, F, frontend_dim) and
refuses a prompt shorter than F (``RequestRejected``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --paged --page-size 8 --draft-tree 2,1 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --smoke --decode-plane --prompt-len 48 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --smoke --decode-plane --paged --prompt-len 40 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \\
        --smoke --decode-plane --spec-tokens 4 --device cpu

The quantized bandwidth plane (``--kv-dtype int8``: int8 KV rows with
per-token scales; ``--expert-dtype int8``: decode reads int8 twins of the
expert stacks with per-expert scales) serves every one of these planes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --spec-tokens 4 --kv-dtype int8 --expert-dtype int8 --device cpu

Request programs (``--program SPEC``, ``Request.program``): each spec is
compiled once (:mod:`repro_torch.core.programs`) to a token automaton whose
allowed sets also live on the card, one (S, V) bool table per program
(:class:`repro_torch.launch.steps.ProgramTable`).  A launch with a
programmed slot runs the masked verify on the card after the graph: the
host walks each draft tree's automaton states (``tree_states``), the card
takes the masked argmax of those nodes' logits, and only the ids come back.
The drafters are steered by the same automaton (the model drafter's logits
ranked on the card among the allowed tokens, the host drafts clamped by
:func:`~repro_torch.launch.speculative.steer_tree_tokens`).  ``"fork": K``
admits K branches off one prefill (contiguous: the first slot's rows copied
to the others; paged: later branches bind the prompt's full pages through
the prefix trie and write only the partial last page) and ``"join"`` picks
the surviving stream.

The fabric (``--fabric N``, ``--inject``, ``--launch-timeout``,
``--checkpoint-dir``, ``--checkpoint-every``): the CLI always serves through
:class:`repro_torch.runtime.fabric.ServeFabric`, N replicas behind one
queue; ``--inject`` drives :mod:`repro_torch.runtime.faults` (a crash drops
the replica, its cache and graphs; the rejoining replica is built anew,
weights restored from the latest :class:`repro_torch.checkpoint.CheckpointManager`
step, graphs captured again):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --spec-tokens 3 --slots 2 --gen 24 --device cpu \\
        --inject crash@step=3 --program '{"segments":[{"kind":"json_schema",
        "schema":{"type":"object","properties":{"a":{"type":"integer","maxDigits":2}}}}]}'

The cross-process fabric (``--workers N``, ``--heartbeat-every``,
``--heartbeat-miss-limit``, ``--deadline``, ``--queue-limit``): N worker
processes (spawned; :mod:`repro_torch.runtime.worker`), each a one-device
replica on ``--device``, supervised by
:class:`repro_torch.runtime.fabric.CrossProcessFabric` through messages and
heartbeats alone; a silent worker is declared dead, its requests requeued
and a replacement spawned that restores the weights from the checkpoint
directory (``kill@step=N`` and ``hang@step=N`` act on the worker process):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --spec-tokens 3 --workers 2 --inject kill@step=7 --device cpu

Expert parallelism (``--model N``): the replica's MoE layers run on a
``(data, model)`` mesh (:mod:`repro_torch.launch.mesh`), the experts split
over the ``model`` axis: the a2a body at prefill, the shard-sliced plan and
one all-reduce a layer at decode (both skipped at one rank)
(:mod:`repro_torch.parallel.moe_parallel`).  ``--data D`` splits the slots
over the data axis (:class:`SlotSplit`: each data group prefills and
launches its own slots and keeps their cache rows; the launches' verified
ids cross ``data``, never logits).  A ``(1, 1)`` mesh (the default) is a
one-rank group in-process; more ranks run under ``torchrun
--nproc-per-node D*M``, every rank serving the same queue and rank 0
printing and dumping.  Fabric checkpoints gather the expert slices whole
(``CheckpointManager.save(..., mesh=)``), and a crash flagged
``shrink=1`` rebuilds the replica on half the ranks, ``model`` kept
(:func:`make_replica_factory`'s ``shrink_to``; the ranks past it exit 0):

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --data 2 --model 2 --inject crash@step=3:shrink=1 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pages import PageTable, PrefixTrie, commit_maps
from repro_torch.core.plans import TreePlan
from repro_torch.core.programs import compile_program, program_slots
from repro_torch.launch.mesh import backend_for, init_single_rank, make_host_mesh, rank_device
from repro_torch.launch.speculative import (
    TREE_DRAFTERS,
    ModelDrafter,
    accept_tree_program,
    greedy_accept_tree,
    steer_tree_tokens,
)
from repro_torch.launch.steps import (
    GraphPool,
    ProgramTable,
    TreeCommit,
    admission,
    batch_rows,
    build_model,
    build_spec_serve_step,
    masked_argmax_rows,
    masked_top_k,
    prefill_model,
)
from repro_torch.parallel.sharding import batch_axes
from repro_torch.models.transformer import check_spec_width, max_pages_for, num_pages
from repro_torch.runtime.fabric import FabricConfig, Request, Result, ServeFabric
from repro_torch.runtime.faults import RequestRejected, TransientLaunchError

DRAFTER_CHOICES = ("model", "ngram", "repeat")


class SlotSplit:
    """Which of a replica's slots this rank serves on the data axes, and the
    control words that cross them.

    Where the mesh's data axes divide the slots (the rule of
    :func:`~repro_torch.parallel.sharding.batch_spec`), data group ``i``
    (its row-major index over those axes) holds slots ``[i B / D, (i + 1)
    B / D)``: their cache rows, their prefills and their launches; where
    they do not, every group serves every slot, as the reference
    replicates such a batch.  Every rank runs the same host loop on the
    same queue, so host state (streams, lengths, plan rows, page tables,
    program states, forks) stays the same on every rank: each launch's
    verified ids, and a model drafter's draft tokens, are gathered over the
    data group, (B / D, T) int32 each, and an admission's first tokens are
    broadcast from the group that owns its first slot.  Control words
    travel as CPU tensors (gloo, on the card too); nothing crosses the data
    axes when the slots do not split."""

    def __init__(self, mesh, slots: int):
        axes = batch_axes(slots, mesh) if mesh is not None else ()
        self.rows = batch_rows(slots, mesh, axes) if axes else slice(0, slots)
        self.size = self.rows.stop - self.rows.start
        self.n = slots // self.size
        self.index = self.rows.start // self.size
        self.group = mesh.group(axes) if self.n > 1 else None

    def owns(self, b: int) -> bool:
        return self.rows.start <= b < self.rows.stop

    def owner(self, b: int) -> int:
        """The index of the data group serving slot ``b``."""
        return b // self.size if self.group is not None else 0

    def gather(self, local: np.ndarray) -> np.ndarray:
        """Every group's (B / D, ...) integer rows, in slot order."""
        if self.group is None:
            return local
        x = torch.from_numpy(np.ascontiguousarray(local, np.int32))
        out = torch.empty((self.n * x.shape[0], *x.shape[1:]), dtype=torch.int32)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.numpy().astype(np.asarray(local).dtype)

    def broadcast(self, values: List[int], src: int) -> List[int]:
        """``values`` of data group ``src``, on every rank (the others pass
        placeholders of the same length)."""
        if self.group is None:
            return values
        x = torch.as_tensor(values, dtype=torch.int64)
        dist.broadcast(x, src=dist.get_global_rank(self.group, src), group=self.group)
        return [int(v) for v in x]


class ServeReplica:
    """The continuous-batching speculative decode loop over a slot pool.

    ``params`` must live on the replica's device; ``device=None`` means the
    card (see :func:`repro_torch.resolve_device`).  With ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`) the model, the admission model
    (:func:`launch.steps.prefill_model`, with the model's MoE applies) and
    the drafter model are bound to it (:func:`launch.steps.build_model`), they
    live on the mesh's device, and ``params`` (and ``drafter_params``) hold
    this rank's expert slice (:func:`parallel.sharding.shard_params`, or the
    bound model's ``init``); every
    rank of the mesh serves the same queue, each data group its own slots
    (:class:`SlotSplit`: ``split``; its cache holds those slots' rows and,
    paged, the whole pool).  ``drafter="model"`` drafts with
    a 1-layer model of the same family (``model_drafter``, its weights
    ``drafter_params``, or drawn from seed 7); ``telemetry`` records the
    plan agreement of every launch in ``agreements``.

    Every decode launch, the contiguous tree commit and the model drafter's
    launches are compiled launches (:mod:`repro_torch.launch.steps`): on
    the card each is captured once in a CUDA graph, all of one replica's
    graphs sharing one memory pool, and replayed; on the CPU each runs
    eagerly on its static buffers.  Admission is always eager: prompt
    lengths vary.  :meth:`reset` returns a drained replica to its state at
    construction, graphs kept.

    Crash model (the fabric's): all of this object may vanish at any point;
    accepted tokens are buffered per request in ``emitted`` and released by
    :meth:`step` only when the request completes.  ``fault_hook(replica_id,
    step, phase, rids)`` is called before each launch (``phase="launch"``,
    ``step`` the 1-based launch index) and each admission (``"admit"``),
    before any state changes; it may raise
    :class:`~repro_torch.runtime.faults.ReplicaCrash` or
    :class:`~repro_torch.runtime.faults.TransientLaunchError`, or return
    synthetic stall seconds; a stall at or past ``launch_timeout`` raises
    ``TransientLaunchError`` before the launch.

    Request programs: ``programs[b]`` is slot b's compiled program (a
    :class:`~repro_torch.launch.steps.ProgramTable`, None when
    unconstrained), ``prog_state[b]`` the automaton state after its
    emitted stream and ``prog_rows[b, p]`` that state per committed stream
    position (only accepted positions are written, as the KV rows beside
    them).  ``steer_drafter`` steers the drafters by each slot's automaton.
    Fork groups (``forks``) track the branch slots serving one request
    until its join."""

    def __init__(self, cfg, slots: int, max_len: int, params, *, tree: Optional[TreePlan] = None,
                 drafter: str = "ngram", telemetry: bool = False, drafter_params=None, device=None,
                 mesh=None, fault_hook=None, replica_id: int = 0, launch_timeout: Optional[float] = None,
                 steer_drafter: bool = True):
        if drafter not in DRAFTER_CHOICES:
            raise ValueError(f"drafter must be one of {sorted(DRAFTER_CHOICES)}, got {drafter!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.model = build_model(cfg, mesh, slots, device)
        self._pf_model = prefill_model(self.model)
        self.split = SlotSplit(mesh, slots)
        Bl = self.split.size
        self.params = params
        self.B, self.max_len = slots, max_len
        self.T = max(cfg.spec_tokens, 1)
        check_spec_width(cfg, self.T)
        if tree is not None and tree.num_nodes != self.T:
            raise ValueError(f"tree has {tree.num_nodes} nodes but cfg.spec_tokens is {self.T}")
        self.tree = tree
        self._branchy = tree is not None and not tree.is_chain()
        self.telemetry = telemetry and cfg.decode_plane and cfg.is_moe
        self.fault_hook = fault_hook
        self.replica_id = replica_id
        self.launch_timeout = launch_timeout
        self.steer_drafter = bool(steer_drafter)
        self.cache = self.model.init_cache(Bl, max_len, pool_batch=slots)
        self.paged = bool(cfg.paged)
        self.graphs = GraphPool(self.model.device) if self.model.device.type == "cuda" else None
        self._decode = build_spec_serve_step(self.model, params, self.cache, batch=Bl, tree=tree,
                                             telemetry=self.telemetry, max_len=max_len, graphs=self.graphs)
        self._commit = None
        if self._branchy and not self.paged:
            self._commit = TreeCommit(self.cache, batch=Bl, T=self.T, graphs=self.graphs)
        self._propose_tree = tree if tree is not None else TreePlan.chain(self.T)
        self._fill = TREE_DRAFTERS.get(drafter, TREE_DRAFTERS["ngram"])
        self.model_drafter = None
        if drafter == "model" and self.T > 1:
            # same family, one layer, width-1 launches, its own contiguous cache
            draft_cfg = dataclasses.replace(cfg, num_layers=1, spec_tokens=1, paged=False)
            draft_model = build_model(draft_cfg, mesh, slots, self.model.device)
            dp = drafter_params if drafter_params is not None else draft_model.init(7)
            self.model_drafter = ModelDrafter(draft_model, dp, Bl, max_len, graphs=self.graphs)

        # paged KV plane: the block table is the control word every launch
        # takes; admission is page binding plus a prefix-trie probe
        self.pager: Optional[PageTable] = None
        self.trie: Optional[PrefixTrie] = None
        self._pending_commit = None  # (dst, src) maps fused into the NEXT launch
        if self.paged:
            self.pager = PageTable(slots, max_pages_for(cfg, max_len), num_pages(cfg, slots, max_len),
                                   cfg.page_size)
            self.trie = PrefixTrie(cfg.page_size)

        B = slots
        self.lengths = np.zeros((B,), np.int32)
        self.prev_accept = np.zeros((B,), np.int32)
        self.last_tok = np.zeros((B,), np.int32)
        self.gen_left = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.history: List[List[int]] = [[] for _ in range(B)]
        self.requests: List[Optional[Request]] = [None] * B
        self.emitted: List[List[int]] = [[] for _ in range(B)]
        self.programs: List[Optional[ProgramTable]] = [None] * B
        self.prog_state = np.full((B,), -1, np.int32)
        self.prog_rows = np.full((B, max_len + 1), -1, np.int32)
        self.fork_branch = np.full((B,), -1, np.int32)
        self.forks: Dict[int, dict] = {}
        self._prog_cache: Dict[str, ProgramTable] = {}
        self.compile_s: Dict[str, float] = {}  # first compile of each spec, seconds
        self._zero_counters()

    def _zero_counters(self) -> None:
        self.steps = 0  # launch counter: the fault specs' step index
        self.launches = 0
        self.prefills = 0
        self.commits = 0  # contiguous tree-commit passes (the paged plane makes none)
        self.commit_moves = 0  # accepted tree nodes off their committed row: one row move each
        self.accepted_total = 0
        self.drafted_total = 0
        self.agreements: List[float] = []
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.last_stall = 0.0
        # request programs: tokens emitted under one, states visited, masked
        # nodes and their masked vocabulary shares, emissions outside the
        # allowed set (must stay 0), launches that ran the masked verify and
        # its host ms (upload, the op on the card, the ids' read back)
        self.prog_states_seen: set = set()
        self.prog_tokens = 0
        self.prog_mask_frac_sum = 0.0
        self.prog_mask_cnt = 0
        self.prog_masked_emissions = 0
        self.verify_launches = 0
        self.verify_ms = 0.0
        self.forks_started = 0
        self.forks_live_max = 0
        self.fork_kv_rows_copied = 0
        if self.paged:
            self.pages_shared_total = 0
            self.admissions_paged = 0
            self.admit_copy_rows = 0
        if self.model_drafter is not None:
            self.model_drafter.launches = 0

    def reset(self) -> None:
        """Return a drained replica to its state at construction, its
        compiled launches kept (a warm-up's captures stay): every counter
        zeroed and, paged, the trie's pages evicted, so the free pages pop
        in the same order as from a new pool, and no commit pending.
        Compiled programs stay cached.  Raises if a request is still in a
        slot."""
        if self.has_work():
            raise RuntimeError("reset of a replica that still serves requests")
        if self.paged:
            while self.trie.evict_one(self.pager):
                pass
            if self.pager.allocated_pages() or self.trie.nodes:
                raise AssertionError("pages still bound after the trie was drained")
        self._pending_commit = None
        self._zero_counters()

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [b for b in range(self.B) if not self.active[b]]

    def has_work(self) -> bool:
        return bool(self.active.any())

    def in_flight(self) -> List[Request]:
        """Requests in the slots, in slot order, each once (a fork's branches
        share one request, which the fabric requeues once: re-admission
        re-forks it from scratch)."""
        out: List[Request] = []
        seen: set = set()
        for r in self.requests:
            if r is not None and r.rid not in seen:
                seen.add(r.rid)
                out.append(r)
        return out

    def snapshot_meta(self) -> dict:
        """JSON-ready slot metadata for the fabric's checkpoint: the
        admission ledger a rejoining replica replays, with the block table
        and the prefix trie under the paged plane, and each programmed
        slot's automaton state (derived state, recorded, not restored)."""
        meta = {
            "steps": int(self.steps),
            "rids": [int(r.rid) for r in self.requests if r is not None],
            "lengths": [int(v) for v in self.lengths],
        }
        if self.paged:
            meta["pager"] = self.pager.snapshot()
            meta["trie"] = self.trie.snapshot()
        progs = {
            str(b): {"state": int(self.prog_state[b]), "branch": int(self.fork_branch[b]),
                     "emitted": len(self.emitted[b])}
            for b in range(self.B) if self.active[b] and self.programs[b] is not None
        }
        if progs:
            meta["programs"] = progs
        return meta

    def paged_stats(self) -> dict:
        """Page-pool telemetry: occupancy, sharing, fragmentation."""
        live = [int(n) for n, a in zip(self.lengths, self.active) if a]
        return {
            "occupancy": self.pager.occupancy(),
            "allocated_pages": self.pager.allocated_pages(),
            "fragmentation": self.pager.fragmentation(live),
            "pages_shared_total": int(self.pages_shared_total),
            "admissions": int(self.admissions_paged),
            "pages_shared_per_admission": self.pages_shared_total / max(self.admissions_paged, 1),
            "admit_copy_rows": int(self.admit_copy_rows),
            "trie_nodes": int(self.trie.nodes),
        }

    def _evict(self) -> bool:
        return self.trie.evict_one(self.pager)

    def _bind_pages(self, b: int, prompt: np.ndarray) -> np.ndarray:
        """Paged admission = page binding + trie probe, never a stripe copy.

        Bind the trie's full pages that already hold this prompt's prefix
        (``probe`` took the references), allocate private pages for the
        rest, publish the prompt's own full pages, and return the
        ``(max_len,)`` physical-row vector for the admission scatter:
        shared positions and positions past the prompt carry the sentinel
        ``num_pages * page_size``, so their writes are dropped (they land in
        the pool's trash row).  Generation writes land at positions >=
        ``len(prompt)``, which shared (full prompt) pages never cover."""
        ps = self.cfg.page_size
        pager, trie = self.pager, self.trie
        L = len(prompt)
        shared = trie.probe(prompt, pager)
        for i, page in enumerate(shared):
            pager.table[b, i] = page  # probe already took our reference
        pager.ensure(b, max(L, 1), evict=self._evict)
        trie.insert(prompt, [int(pager.table[b, i]) for i in range(L // ps)], pager)
        rows = np.full((self.max_len,), pager.num_pages * ps, np.int32)
        for pos in range(len(shared) * ps, L):
            rows[pos] = int(pager.table[b, pos // ps]) * ps + pos % ps
        self.pages_shared_total += len(shared)
        self.admit_copy_rows += max(L - len(shared) * ps, 0)
        self.admissions_paged += 1
        return rows

    # ------------------------------------------------------------------
    def _compiled_program(self, spec: Optional[dict]) -> Optional[ProgramTable]:
        """Compile (and cache) a request's program spec with its allowed
        table on the card; the cache key is the spec's canonical dump."""
        if not spec:
            return None
        key = json.dumps(spec, sort_keys=True)
        table = self._prog_cache.get(key)
        if table is None:
            t0 = time.perf_counter()
            table = ProgramTable(compile_program(spec, self.cfg.vocab_size), self.model.device)
            self.compile_s[key] = time.perf_counter() - t0
            self._prog_cache[key] = table
        return table

    def admit(self, req: Request) -> int:
        """Prefill ``req`` into a free slot; returns the (first) slot.

        Raises :class:`RequestRejected` for requests that can never finish
        within the slot budget, and for a frontend arch's prompt shorter
        than its frontend positions (checked before any launch), and lets the
        fault hook veto the admission while no state has been touched.  A
        fork program admits into ``fork`` slots off ONE prefill
        (:func:`repro_torch.launch.steps.admission`); branch ``i``'s first
        token is the ``i``-th best allowed token of the prefill logits,
        ranked on the card."""
        spec = getattr(req, "program", None)
        try:
            table = self._compiled_program(spec)
        except ValueError as err:
            raise RequestRejected(f"bad program spec: {err}", rid=req.rid)
        prog = table.program if table is not None else None  # the RequestProgram: fork, join, automaton
        k = prog.fork if prog is not None else 1
        if self.cfg.frontend and len(req.prompt) < self.cfg.frontend_tokens:
            raise RequestRejected(
                f"prompt len {len(req.prompt)} is shorter than the {self.cfg.frontend_tokens} frontend "
                f"positions it must cover", rid=req.rid)
        if len(req.prompt) + req.gen + self.T > self.max_len:
            raise RequestRejected(
                f"prompt len {len(req.prompt)} + gen {req.gen} + spec width "
                f"{self.T} exceeds the slot budget {self.max_len}", rid=req.rid)
        if k > self.B:
            raise RequestRejected(f"program forks {k} ways but the replica has {self.B} slots", rid=req.rid)
        if prog is not None and len(prog.automaton.allowed(prog.automaton.start)) < k:
            raise RequestRejected(
                f"program forks {k} ways but its grammar allows only "
                f"{len(prog.automaton.allowed(prog.automaton.start))} first tokens", rid=req.rid)
        free = self.free_slots()
        if len(free) < k:
            raise RuntimeError(f"replica {self.replica_id}: no free slot ({k} needed, {len(free)} available)")
        if self.fault_hook is not None:
            self.fault_hook(self.replica_id, self.steps + 1, "admit", (req.rid,))
        slots = free[:k]
        prompt = np.asarray(req.prompt, np.int32)
        t0 = time.perf_counter()
        rows = None
        if self.paged:
            rows = []
            for i, b in enumerate(slots):
                copied0 = self.admit_copy_rows
                rows.append(self._bind_pages(b, prompt))
                if i > 0:  # a later branch writes only what the trie does not share
                    self.fork_kv_rows_copied += self.admit_copy_rows - copied0
        elif k > 1:
            self.fork_kv_rows_copied += (k - 1) * len(prompt)
        split, lo = self.split, self.split.rows.start
        if self.paged:  # the pool has no batch dim: every group writes the prompt's rows, each its own slots' state
            local = [b - lo if split.owns(b) else None for b in slots]
        else:
            local = [b - lo for b in slots if split.owns(b)]
        logits = None
        if self.paged or local:
            logits = admission(self.model, self.params, self.cache, prompt, local, rows, self._pf_model,
                               self.model.frontend_stub(1))
        # the group that owns the first slot ranks the first tokens, and every rank takes them
        src = split.owner(slots[0])
        firsts = [0] * (k if prog is not None else 1)
        if src == split.index:
            if prog is not None:
                firsts = [int(v) for v in masked_top_k(logits[None], table.allowed, np.zeros(1, np.int64),
                                                       np.asarray([prog.automaton.start]), k)[0].cpu()]
            else:
                firsts = [int(torch.argmax(logits))]
        firsts = split.broadcast(firsts, src)
        if prog is not None:
            auto = prog.automaton
            self.prog_mask_cnt += k
            self.prog_mask_frac_sum += k * float(table.masked_frac[auto.start])
            self.prog_states_seen.add(int(auto.start))
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        self.prefills += 1
        if k > 1:
            self.forks[req.rid] = {"req": req, "k": k, "join": prog.join, "streams": {}, "accepted": {},
                                   "retired": set()}
            self.forks_started += 1
            self.forks_live_max = max(self.forks_live_max, k + sum(
                1 for b in range(self.B) if self.active[b] and self.fork_branch[b] >= 0))
        for i, b in enumerate(slots):
            first = firsts[i]
            self.lengths[b] = len(prompt)
            self.last_tok[b] = first
            self.prev_accept[b] = 0
            self.gen_left[b] = req.gen
            self.active[b] = True
            self.history[b] = [first]
            self.requests[b] = req
            self.emitted[b] = [first]
            self.programs[b] = table
            self.fork_branch[b] = i if k > 1 else -1
            if prog is not None:
                st = prog.automaton.step(prog.automaton.start, first)
                if st < 0:
                    self.prog_masked_emissions += 1
                self.prog_state[b] = st
                self.prog_rows[b] = -1
                self.prog_rows[b, len(prompt)] = st
                self.prog_states_seen.add(int(st))
                self.prog_tokens += 1
            else:
                self.prog_state[b] = -1
            if self.model_drafter is not None and split.owns(b):
                self.model_drafter.admit(b - lo, prompt)
        return slots[0]

    def _guide(self, b: int):
        """(program table, automaton state) steering slot b's drafts, or None."""
        if not self.steer_drafter or not self.active[b] or self.programs[b] is None:
            return None
        return self.programs[b], int(self.prog_state[b])

    def _masked_verify(self, toks: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Overwrite ``y`` at every node of a programmed slot with the masked
        argmax of its logits: the node's automaton state (its root path's
        draft tokens walked from the slot's state) selects the allowed set.
        The states are walked on the host, the argmax runs on the card on
        the step's logits, and only the ids come back.  Along the accepted
        path draft tokens ARE the emitted stream, so the emissions equal a
        sequential masked loop's.  ``y`` holds this rank's slots
        (:class:`SlotSplit`): the states and counters are every slot's, the
        argmax runs on its own slots' nodes."""
        parents = self._propose_tree.parents
        lo = self.split.rows.start
        groups: Dict[int, tuple] = {}
        masked = False
        for b in range(self.B):
            table = self.programs[b]
            if table is None or not self.active[b]:
                continue
            auto = table.automaton
            if auto.is_accept(int(self.prog_state[b])):
                continue  # stream already complete: nothing to emit
            A = auto.tree_states(int(self.prog_state[b]), toks[b], parents)
            for t in range(self.T):
                st = int(A[t])
                if st < 0 or auto.is_accept(st):
                    continue  # unreachable node (or past the stop): don't-care
                masked = True
                self.prog_mask_cnt += 1
                self.prog_mask_frac_sum += float(table.masked_frac[st])
                if self.split.owns(b):
                    groups.setdefault(id(table), (table, []))[1].append((b - lo, t, st))
        if not masked:
            return y
        self.verify_launches += 1
        if not groups:
            return y
        t0 = time.perf_counter()
        logits = self._decode.logits.reshape(self.split.size * self.T, -1)
        picked = [masked_argmax_rows(logits, table.allowed, np.asarray([b * self.T + t for b, t, _ in nodes]),
                                     np.asarray([st for _, _, st in nodes]))
                  for table, nodes in groups.values()]
        ids = torch.cat(picked).cpu().numpy()
        y = np.array(y)
        for (b, t, _), v in zip((n for _, nodes in groups.values() for n in nodes), ids):
            y[b, t] = v
        self.verify_ms += (time.perf_counter() - t0) * 1e3
        return y

    def step(self) -> List[Result]:
        """One speculative launch over the pool: draft, decode, (masked)
        greedy verify/rollback, tree commit; returns the requests that
        completed (their full buffered streams; a fork's once joined)."""
        if not self.active.any():
            return []
        step_no = self.steps + 1
        self.last_stall = 0.0
        if self.fault_hook is not None:
            rids = tuple(r.rid for r in self.requests if r is not None)
            stall = float(self.fault_hook(self.replica_id, step_no, "launch", rids) or 0.0)
            if self.launch_timeout is not None and stall >= self.launch_timeout:
                # fail fast before the launch: state is never half-changed
                raise TransientLaunchError(
                    f"launch exceeded the {self.launch_timeout:.1f}s timeout (stalled {stall:.1f}s)")
            self.last_stall = stall
        self.steps = step_no

        T, B = self.T, self.B
        # programmed slots steer every drafter by their automaton: the model
        # drafter ranks among allowed tokens on the card, the host drafts
        # are clamped after the fill
        guides = [self._guide(b) for b in range(B)]
        loc, lo = self.split.rows, self.split.rows.start
        if self.model_drafter is not None:
            # the drafter serves this rank's slots; their drafts cross the data axes
            self.model_drafter.catch_up()
            g_loc = guides[loc]
            toks = self.split.gather(self.model_drafter.propose(
                self.last_tok[loc], self.lengths[loc], self._propose_tree,
                g_loc if any(g is not None for g in g_loc) else None))
        else:
            toks = np.zeros((B, T), np.int32)
            for b in range(B):
                if self.active[b] and T > 1:
                    toks[b] = self._fill(self.history[b], int(self.last_tok[b]), self._propose_tree)
        toks[:, 0] = self.last_tok
        if T > 1:
            for b, g in enumerate(guides):
                if g is not None and g[1] >= 0:
                    toks[b] = steer_tree_tokens(toks[b], self._propose_tree, g[0].automaton, g[1],
                                                self.history[b])

        pages = commit = None
        if self.paged:
            # grow each active slot's block table to cover this launch's
            # writes before the launch takes it
            for b in range(B):
                if self.active[b]:
                    self.pager.ensure(b, int(self.lengths[b]) + T, evict=self._evict)
            pages = self.pager.table
            if self._branchy:
                # the previous verify round's accepted path, as row moves
                # fused into this launch; no-ops on the first launch
                none = np.full((B, T), -1, np.int32)
                commit = self._pending_commit if self._pending_commit is not None else (none, none)
        t0 = time.perf_counter()
        y, agree = self._decode(toks[loc], self.lengths[loc], self.prev_accept[loc],
                                pages=None if pages is None else pages[loc],
                                commit=None if commit is None else (commit[0][loc], commit[1][loc]))
        self.decode_ms += (time.perf_counter() - t0) * 1e3
        self.launches += 1
        if self.telemetry:
            self.agreements.append(agree)  # this rank's slots' agreement
        y = self.split.gather(self._masked_verify(toks, y))

        path_pad = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        acc_n = np.zeros((B,), np.int32)
        prog_done = np.zeros((B,), bool)
        for b in range(B):
            if not self.active[b]:
                self.lengths[b] = 0  # park finished slots at depth 0
                continue
            prog = self.programs[b]
            if prog is not None and prog.automaton.is_accept(int(self.prog_state[b])):
                prog_done[b] = True  # accepted at admission (a one-token grammar): emit nothing
                continue
            if prog is not None:
                path, _, prog_done[b] = accept_tree_program(toks[b], y[b], self._propose_tree,
                                                            int(self.gen_left[b]), prog.automaton,
                                                            int(self.prog_state[b]))
            else:
                path = greedy_accept_tree(toks[b], y[b], self._propose_tree, int(self.gen_left[b]))
            a = len(path)
            path_pad[b, :a] = path
            self.commit_moves += sum(int(p != i) for i, p in enumerate(path))
            accepted = [int(y[b, p]) for p in path]
            self.prev_accept[b] = path[-1]
            if self.model_drafter is not None and self.split.owns(b):
                # rows [lengths, lengths + a) of the true stream: the launch
                # input followed by all but the last accepted token
                self.model_drafter.observe(b - lo, [int(self.last_tok[b])] + accepted[:-1])
            self.history[b].extend(accepted)
            self.emitted[b].extend(accepted)
            if prog is not None:
                # the carried state advances by the accepted emissions only
                # (rejected nodes never touch it), mirrored per position
                auto = prog.automaton
                st = int(self.prog_state[b])
                for i, tok in enumerate(accepted):
                    if st < 0 or auto.trans[st, tok] < 0:
                        self.prog_masked_emissions += 1
                    st = auto.step(st, tok)
                    self.prog_rows[b, int(self.lengths[b]) + 1 + i] = st
                    self.prog_states_seen.add(int(st))
                self.prog_state[b] = st
                self.prog_tokens += a
            self.accepted_total += a
            self.drafted_total += T
            acc_n[b] = a
            self.gen_left[b] -= a
            self.last_tok[b] = accepted[-1]
        if self._branchy:
            if self.paged:
                # maps from the PRE-accept lengths, consumed by the next launch
                self._pending_commit = commit_maps(self.lengths, path_pad, acc_n, T)
            else:
                # before lengths advance: accepted nodes move from rows
                # base + u_i to base + i
                self._commit(self.lengths[loc], path_pad[loc])
                self.commits += 1

        done: List[Result] = []
        for b in range(B):
            if not self.active[b]:
                continue
            self.lengths[b] += acc_n[b]
            if prog_done[b] or self.gen_left[b] <= 0 or self.lengths[b] + T > self.max_len:
                req = self.requests[b]
                if self.fork_branch[b] >= 0:
                    # a branch never publishes alone: its stream joins the group
                    grp = self.forks[req.rid]
                    i = int(self.fork_branch[b])
                    grp["streams"][i] = list(self.emitted[b])
                    grp["accepted"][i] = bool(prog_done[b])
                else:
                    done.append(Result(rid=req.rid, tokens=list(self.emitted[b]), replica=self.replica_id))
                self._retire_slot(b)
        for rid in list(self.forks):
            res = self._maybe_resolve_fork(rid)
            if res is not None:
                done.append(res)
        return done

    def _retire_slot(self, b: int) -> None:
        """Release slot ``b``: its program cleared, pages recycled and its
        pending commit voided (its freed pages may be bound again before
        the next launch)."""
        self.active[b] = False
        self.requests[b] = None
        self.emitted[b] = []
        self.programs[b] = None
        self.prog_state[b] = -1
        self.fork_branch[b] = -1
        if self.paged:
            self.pager.free_slot(b)
            if self._pending_commit is not None:
                self._pending_commit[0][b] = -1
                self._pending_commit[1][b] = -1

    def _maybe_resolve_fork(self, rid: int) -> Optional[Result]:
        """Join/stop for one fork group.

        ``join="first"``: the winner is the branch whose ACCEPTED stream is
        shortest (ties to the lowest branch index); a live branch already
        too long to beat the best accepted stream is retired on the spot,
        its slot and pages recycled.  ``join="all"`` runs every branch to
        completion and publishes all streams (concatenated in branch order,
        the per-branch split in ``Result.branches``)."""
        grp = self.forks[rid]
        k, join = grp["k"], grp["join"]
        streams, acc = grp["streams"], grp["accepted"]
        if join == "first":
            wins = [(len(streams[i]), i) for i in streams if acc.get(i)]
            if wins:
                best = min(wins)
                for b in range(self.B):
                    if self.active[b] and self.requests[b] is not None and self.requests[b].rid == rid:
                        j = int(self.fork_branch[b])
                        # to win, branch j must still accept at a length
                        # >= emitted + 1: retire it once that cannot beat best
                        if (len(self.emitted[b]) + 1, j) > best:
                            grp["retired"].add(j)
                            self._retire_slot(b)
        if len(streams) + len(grp["retired"]) < k:
            return None
        cands = [i for i in streams if acc.get(i)] or sorted(streams)
        win = min(cands, key=lambda i: (len(streams[i]), i))
        del self.forks[rid]
        if join == "all":
            ordered = [streams[i] for i in sorted(streams)]
            return Result(rid=rid, tokens=[t for s in ordered for t in s], replica=self.replica_id,
                          branches=ordered)
        return Result(rid=rid, tokens=list(streams[win]), replica=self.replica_id)


# ---------------------------------------------------------------------------
# fabric assembly (shared by the CLI and the fault-tolerance tests)
# ---------------------------------------------------------------------------


def degrade_ladder(tree: Optional[TreePlan], spec_width: int) -> List[Any]:
    """The speculation ladder a flagged replica descends: ``(tree, width)``
    per level: the full tree, then the chain of its spine, then width 1."""
    ladder = []
    if tree is not None and not tree.is_chain():
        ladder.append((tree, tree.num_nodes))
        chain_w = len(tree.spine())
    else:
        chain_w = spec_width
    if chain_w > 1:
        ladder.append((None, chain_w))
    ladder.append((None, 1))
    return ladder


def make_replica_factory(cfg, slots: int, max_len: int, params, ladder, *, drafter: str = "ngram",
                         telemetry: bool = False, fault_hook=None, launch_timeout: Optional[float] = None,
                         ckpt=None, shrink_to: Optional[tuple] = None, device=None, mesh=None, drafter_params=None):
    """The fabric's replica factory ``make(replica_id, level, params_,
    shrunk)``: a :class:`ServeReplica` at ladder ``level``, with
    ``params_`` (the checkpoint-restored weights of a re-warm rebuild) or
    ``params``.

    A crash flagged as device loss (``shrunk``) with ``shrink_to =
    (n_healthy, model_axis)`` and a committed step in ``ckpt`` rebuilds
    through :func:`repro_torch.runtime.elastic.reshard_serve_after_failure`,
    as the reference's factory does: ``model`` kept, ``data`` shrunk, the
    params restored as this rank's share of the survivors' mesh, whose
    fresh default group meets in ``ckpt``'s directory (a file store named
    by the replica, the mesh and the step, the same on every rank).  Every
    rank of ``mesh`` runs the factory at the same round; the survivors are
    ranks ``0 .. n`` of the old group (``n = n_healthy // model_axis *
    model_axis``), so each keeps its ``model`` coordinate and its expert
    slice, and the mesh every later rebuild uses is the survivors'.  A rank
    past them leaves its old group and raises
    :class:`~repro_torch.runtime.elastic.LeftMesh` out of the fabric's
    ``run``: it serves no more, and the CLI exits 0 there."""
    if shrink_to is not None and mesh is None:
        raise ValueError("the elastic re-shard rebuild (shrink_to) rebuilds a mesh: pass the replica's mesh")
    world = {"mesh": mesh}

    def make(replica_id: int, level: int, params_=None, shrunk: bool = False):
        tr, width = ladder[min(level, len(ladder) - 1)]
        cfg_l = dataclasses.replace(cfg, spec_tokens=width)
        p = params_ if params_ is not None else params
        if shrunk and shrink_to is not None and ckpt is not None and ckpt.latest_step() is not None:
            from repro_torch.configs import ShapeCell
            from repro_torch.runtime.elastic import LeftMesh, reshard_serve_after_failure

            n_healthy, model_axis = shrink_to
            keep = n_healthy // model_axis * model_axis
            rank = dist.get_rank()
            if rank >= keep:
                dist.destroy_process_group()
                raise LeftMesh(f"rank {rank} is not one of the {keep} ranks of the survivors' mesh")
            rendezvous = ckpt.dir / f"rendezvous_r{replica_id}_{keep}x{model_axis}_s{ckpt.latest_step()}"
            state = reshard_serve_after_failure(cfg_l, ShapeCell("d", max_len, slots, "decode"), ckpt,
                                                n_healthy=n_healthy, model_axis=model_axis,
                                                device=world["mesh"].device, init_method=f"file://{rendezvous}",
                                                rank=rank)
            world["mesh"], p = state.mesh, state.params
        return ServeReplica(cfg_l, slots, max_len, p, tree=tr, drafter=drafter, telemetry=telemetry,
                            drafter_params=drafter_params, device=device, mesh=world["mesh"],
                            fault_hook=fault_hook, replica_id=replica_id, launch_timeout=launch_timeout)

    return make


# ---------------------------------------------------------------------------
# queue, admission loop, CLI
# ---------------------------------------------------------------------------


def synthetic_requests(vocab_size: int, prompt_len: int, gen: int, n_req: int,
                       shared_prefix: int = 0, program: Optional[dict] = None) -> List[Request]:
    """The reference CLI's synthetic ragged queue (same seed, same draws):
    one shared system prompt of ``shared_prefix`` tokens is drawn first and
    heads every prompt; the rest cycle through three length buckets; every
    request carries ``program``."""
    S = prompt_len
    buckets = sorted({max(4, S // 2), max(4, (3 * S) // 4), S})
    rng = np.random.default_rng(0)
    sys_prompt = np.asarray(rng.integers(0, vocab_size, size=shared_prefix), np.int32)
    return [
        Request(
            rid=i,
            prompt=np.concatenate([
                sys_prompt,
                np.asarray(rng.integers(0, vocab_size, size=buckets[i % len(buckets)]), np.int32),
            ]),
            gen=gen,
            program=program,
        )
        for i in range(n_req)
    ]


def serve_queue(rep: ServeReplica, requests: List[Request]) -> Dict[int, Result]:
    """Serve the queue on ``rep`` until every request is answered: the
    fabric's loop over this one replica, with no faults and no checkpoints
    (one admission rule for both: a fork waits for as many free slots as it
    has branches)."""
    return ServeFabric(lambda *_: rep, requests, FabricConfig(n_replicas=1)).run()


def _dump_tokens(path: str, results: Dict[int, Result]) -> None:
    """Write {rid: token stream} JSON for cross-run stream-identity diffs."""
    if not path:
        return
    with open(path, "w") as f:
        json.dump({str(rid): list(map(int, r.tokens)) for rid, r in sorted(results.items())}, f)


def supervisor_params(cfg, device) -> Any:
    """The weights a cross-process supervisor checkpoints: drawn from seed 0
    on ``device``, the workers' device type (a CUDA generator's stream is
    not the CPU's, so weights drawn elsewhere would differ from the
    workers'), and held in host memory: on the card each leaf is copied to
    the host and the card's copy freed before any worker spawns."""
    from repro_torch.models.model import Model

    params = Model(cfg, device=device).init(0)
    if device.type != "cuda":
        return params

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(host(v) for v in tree)
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    params = host(params)
    torch.cuda.empty_cache()
    return params


def xfabric_config(workers: int, slots: int, *, heartbeat_every: float = 0.25, heartbeat_miss_limit: int = 12,
                   queue_limit: int = 0, checkpoint: bool = False):
    """The CLI's cross-process supervision: a 60 s liveness holiday while a
    worker boots (interpreter start and ``import torch``; the heartbeat
    thread starts before the model build, so builds and captures need no
    headroom), a round every ``min(heartbeat_every / 2, 0.1)`` s, and with
    a checkpoint a snapshot at round 1 and every 50 rounds."""
    from repro_torch.runtime.fabric import XFabricConfig

    return XFabricConfig(
        workers=workers, slots_per_worker=slots, heartbeat_every=heartbeat_every,
        heartbeat_miss_limit=heartbeat_miss_limit, spawn_grace=60.0, poll_every=min(heartbeat_every / 2, 0.1),
        queue_limit=queue_limit, checkpoint_every=50 if checkpoint else 0,
    )


def run_cross_process(args, cfg, requests, params, specs, ckpt, *, spec_width: int, branching, max_len: int,
                      device) -> int:
    """Serve through the cross-process fabric: real OS worker processes,
    heartbeat liveness, deadline-aware admission, checkpoint re-warm.

    Every worker builds a one-device :class:`ServeReplica` on ``device``
    from the config fields in its spec and the seed (a replacement from the
    newest checkpoint), loading the kernel libraries built here first.
    Returns a process exit code: nonzero on any unanswered, dropped or
    duplicated rid, on an error result that no injected fault, deadline or
    queue limit explains, or on a token emitted outside its program's
    allowed set: a zero exit IS the exactly-once assertion."""
    from repro_torch.runtime.fabric import CrossProcessFabric
    from repro_torch.runtime.transport import MonotonicClock, make_process_spawn

    if device.type == "cuda":
        from repro_torch.kernels import build_all

        build_all()
    clock = MonotonicClock()
    if args.deadline > 0:
        t0 = clock.now()
        for req in requests:
            req.deadline = t0 + args.deadline
    spec_base = dict(
        kind="serve", arch=args.arch, smoke=args.smoke, decode_plane=cfg.decode_plane, spec_tokens=spec_width,
        draft_tree=branching, paged=cfg.paged, page_size=cfg.page_size, kv_dtype=cfg.kv_dtype,
        expert_dtype=cfg.expert_dtype, drafter=args.drafter, slots=args.slots, max_len=max_len, seed=0,
        faults=args.inject, launch_timeout=args.launch_timeout, ckpt_dir=str(ckpt.dir) if ckpt is not None else None,
        heartbeat_every=args.heartbeat_every, device=str(device),
    )
    fabric = CrossProcessFabric(
        make_process_spawn(spec_base), requests,
        xfabric_config(args.workers, args.slots, heartbeat_every=args.heartbeat_every,
                       heartbeat_miss_limit=args.heartbeat_miss_limit, queue_limit=args.queue_limit,
                       checkpoint=ckpt is not None),
        clock=clock, specs=specs, ckpt=ckpt, params=params,
    )
    t0 = clock.now()
    results = fabric.run()
    wall = clock.now() - t0
    _dump_tokens(args.dump_tokens, results)

    st = fabric.stats
    finished = sum(1 for r in results.values() if r.error is None)
    print(f"served {finished}/{len(requests)} requests across {args.workers} worker processes ({args.slots} "
          f"slots each, {device}): {st['accepted']} tokens in {wall:.1f} s ({st['launches']} launches, "
          f"{st['admitted']} admissions)")
    print(f"xproc fabric: {st['kills']} kills, {st['heartbeat_misses']} heartbeat misses, {st['spawns']} spawns "
          f"({st['restores']} checkpoint re-warms), {st['requeued']} re-queued, {st['deadline_expired']} "
          f"deadline-expired, {st['backpressure_rejects']} backpressure-rejected, {st['transient_failures']} "
          f"transient, {st['poisoned']} poisoned, {st['stale_messages']} stale messages dropped, "
          f"{st['dropped']} dropped, {st['duplicates']} duplicates")

    unanswered = [r.rid for r in requests if r.rid not in results]
    errors = [r for r in results.values() if r.error is not None]
    expected_errors = any(s.kind == "poison" for s in specs) or args.deadline > 0 or args.queue_limit > 0
    code = 0
    if unanswered:
        print(f"FABRIC ERROR: {len(unanswered)} requests unanswered: {unanswered}")
        code = 1
    if errors and not expected_errors:
        print(f"FABRIC ERROR: {len(errors)} requests errored without an explaining fault/deadline/queue-limit: "
              f"{[(r.rid, r.error) for r in errors]}")
        code = 1
    if st["duplicates"] or st["dropped"]:
        print(f"FABRIC ERROR: {st['duplicates']} duplicate / {st['dropped']} dropped results")
        code = 1
    if args.program:
        print(f"programs: {st['prog_tokens']} constrained tokens, {st['forks_started']} forks, "
              f"{st['fork_kv_rows_copied']} KV rows copied at fork, {st['prog_masked_emissions']} masked emissions")
        if st["prog_masked_emissions"]:
            print(f"FABRIC ERROR: {st['prog_masked_emissions']} tokens emitted outside their automaton's "
                  f"allowed set")
            code = 1
    return code


def _cli_checkpoint(args, cfg, checkpoint_every: int):
    """(manager, temporary directory) of the CLI's fabric checkpoints: a
    ``CheckpointManager`` keeping 2 steps in ``--checkpoint-dir``, or in a
    temporary directory the caller cleans up (on a mesh of several ranks
    rank 0 makes it and every rank opens the same one); (None, None)
    without checkpoints."""
    from repro_torch.checkpoint import CheckpointManager

    if not checkpoint_every:
        return None, None
    path, tmpdir = args.checkpoint_dir, None
    if not path:
        lead = not dist.is_initialized() or dist.get_rank() == 0
        tmpdir = tempfile.TemporaryDirectory(prefix="serve_fabric_ckpt_") if lead else None
        path = tmpdir.name if lead else None
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [path]
            dist.broadcast_object_list(box, src=0)
            path = box[0]
    return CheckpointManager(path, keep=2, cfg=cfg), tmpdir


def _cross_process_cli(args, cfg, T: int, specs, prog_spec, checkpoint_every: int, device) -> int:
    """The CLI's run through worker processes: the synthetic queue, and with
    a checkpoint the supervisor's weights and a manager (a temporary
    directory unless ``--checkpoint-dir``)."""
    max_len = args.prompt_len + args.shared_prefix + args.gen + T
    requests = synthetic_requests(cfg.vocab_size, args.prompt_len, args.gen,
                                  args.requests or 2 * args.slots * args.fabric, args.shared_prefix, prog_spec)
    ckpt, tmpdir = _cli_checkpoint(args, cfg, checkpoint_every)
    params = supervisor_params(cfg, device) if ckpt is not None else None
    branching = [int(v) for v in args.draft_tree.split(",") if v.strip()] or None
    try:
        return run_cross_process(args, cfg, requests, params, specs, ckpt, spec_width=T, branching=branching,
                                 max_len=max_len, device=device)
    finally:
        if tmpdir is not None:
            tmpdir.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="decode slot pool size per replica")
    ap.add_argument("--prompt-len", type=int, default=64, help="max synthetic prompt length")
    ap.add_argument("--gen", type=int, default=16, help="tokens to generate per request")
    ap.add_argument("--requests", type=int, default=0, help="queued requests (default 2x slots x replicas)")
    ap.add_argument("--decode-plane", action="store_true", help="serve decode on the Agile decode plane")
    ap.add_argument("--spec-tokens", type=int, default=1, help="tokens per decode launch")
    ap.add_argument("--draft-tree", default="",
                    help="comma-separated per-depth branching factors of a draft tree, e.g. '2,2' "
                         "(the first child continues the spine); overrides --spec-tokens with the node count")
    ap.add_argument("--paged", action="store_true",
                    help="serve KV through the paged plane: a page pool, per-slot block tables, "
                         "prefix sharing across admissions")
    ap.add_argument("--page-size", type=int, default=0, help="KV rows per page (0 = config default)")
    ap.add_argument("--kv-dtype", choices=("", "int8"), default="",
                    help="store the KV cache in int8 with one f32 scale per token row (the decode kernels "
                         "dequantize each row as it loads)")
    ap.add_argument("--expert-dtype", choices=("", "int8"), default="",
                    help="serve decode through int8 twins of the expert stacks with per-expert f32 scales "
                         "(prefill keeps the full-precision stacks)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a shared synthetic system prompt of this many tokens to every request")
    ap.add_argument("--expect-shared-pages", action="store_true",
                    help="exit 1 unless at least one page was shared across admissions")
    ap.add_argument("--drafter", choices=DRAFTER_CHOICES, default="ngram",
                    help="draft policy: host heuristics (ngram, repeat) or a 1-layer draft model")
    ap.add_argument("--telemetry", action="store_true", help="report stale-vs-fresh plan top-k agreement")
    ap.add_argument("--dump-tokens", default="", help="write {rid: token stream} JSON here")
    ap.add_argument("--program", default="",
                    help="request program applied to every request: inline JSON spec or @path/to/spec.json "
                         "(automaton segments of kind json_schema / literal / tokens, optional \"fork\": K "
                         "and \"join\"); compiled to token-automaton tables by repro_torch.core.programs and "
                         "enforced inside verify; exit 1 if any token is emitted outside its allowed set")
    ap.add_argument("--fabric", type=int, default=1,
                    help="number of data-parallel serve replicas behind the shared admission queue")
    ap.add_argument("--inject", default="",
                    help="deterministic fault specs, e.g. 'crash@step=7,launch@step=3:times=2,"
                         "stall@secs=9:times=4,poison@rid=0' (see repro_torch.runtime.faults)")
    ap.add_argument("--launch-timeout", type=float, default=30.0,
                    help="per-launch timeout in seconds; a stalled launch fails fast as a transient error "
                         "and is retried with backoff")
    ap.add_argument("--checkpoint-dir", default="",
                    help="fabric snapshot directory (params + admission ledger); defaults to a temporary "
                         "directory when faults are injected")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="rounds between fabric snapshots (0 = off; defaults to 4 when --inject is set)")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve through N real OS worker processes (the cross-process fabric): heartbeat-"
                         "supervised one-device replicas whose only coupling to the supervisor is messages and "
                         "the checkpoint directory (0 = the in-process --fabric supervisor)")
    ap.add_argument("--heartbeat-every", type=float, default=0.25,
                    help="worker heartbeat period in seconds (cross-process fabric); liveness deadlines are "
                         "multiples of it")
    ap.add_argument("--heartbeat-miss-limit", type=int, default=12,
                    help="consecutive missed heartbeat deadlines before a worker is declared dead, reaped and "
                         "respawned")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds from submission (cross-process fabric; 0 = none): a "
                         "request expired while queued errors without costing a launch")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="admission queue high-water mark (cross-process fabric; 0 = unbounded): submissions "
                         "past it are rejected with a counted error result")
    ap.add_argument("--device", default=None, help="cuda (default: cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel mesh axis: the slots split over it where it divides them "
                         "(--data x --model ranks under torchrun)")
    ap.add_argument("--model", type=int, default=1,
                    help="expert-parallel mesh axis: ranks the experts split over (N > 1 under torchrun)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime.faults import parse_faults

    tree = None
    T = max(args.spec_tokens, 1)
    if args.draft_tree:
        tree = TreePlan.from_branching([int(v) for v in args.draft_tree.split(",") if v.strip()]).validate()
        T = tree.num_nodes
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(
        cfg, decode_plane=args.decode_plane or cfg.decode_plane, spec_tokens=T,
        paged=args.paged or cfg.paged, page_size=args.page_size or cfg.page_size,
        kv_dtype=args.kv_dtype or cfg.kv_dtype, expert_dtype=args.expert_dtype or cfg.expert_dtype,
    )
    try:
        check_spec_width(cfg, T)
    except NotImplementedError as err:
        ap.error(str(err))
    telemetry = args.telemetry and cfg.decode_plane and cfg.is_moe
    if args.workers < 0:
        ap.error(f"--workers must be >= 0, got {args.workers}")
    if args.workers and (args.model > 1 or args.data > 1):
        ap.error("--workers serves through one-device worker processes: --model and --data stay 1")
    if args.data < 1 or args.model < 1:
        ap.error(f"--data and --model must be >= 1, got {args.data} and {args.model}")
    if args.fabric < 1:
        ap.error(f"--fabric must be >= 1, got {args.fabric}")
    try:
        specs = parse_faults(args.inject)
    except ValueError as err:
        ap.error(f"--inject: {err}")
    prog_spec = None
    if args.program:
        raw = args.program
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        try:
            prog_spec = json.loads(raw)
            compile_program(prog_spec, cfg.vocab_size)  # fail fast on a bad spec
        except ValueError as err:
            ap.error(f"--program: {err}")
        if program_slots(prog_spec) > args.slots:
            ap.error(f"--program forks {program_slots(prog_spec)} ways but --slots is {args.slots}")
    checkpoint_every = args.checkpoint_every or (4 if specs else 0)
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if (world or 1) != args.data * args.model:
        ap.error(f"a ({args.data}, {args.model}) mesh runs one rank per process: launch it with "
                 f"torchrun --nproc-per-node {args.data * args.model} (WORLD_SIZE is {world or 'unset'})")
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if args.workers:
        return _cross_process_cli(args, cfg, T, specs, prog_spec, checkpoint_every, device)
    own_group = not dist.is_initialized()
    if own_group:
        if world:
            dist.init_process_group(backend_for(device), init_method="env://")
        else:
            init_single_rank(device)
    try:
        return _serve_cli(args, cfg, tree, T, telemetry, make_host_mesh(args.data, args.model, device),
                          specs, prog_spec, checkpoint_every)
    finally:
        if own_group and dist.is_initialized():  # a rank that left the survivors' mesh has no group left
            dist.destroy_process_group()


def _serve_cli(args, cfg, tree: Optional[TreePlan], T: int, telemetry: bool, mesh, specs, prog_spec,
               checkpoint_every: int) -> int:
    """The CLI's serving run on this rank of ``mesh``, through the fabric;
    rank 0 prints and dumps."""
    from repro_torch.runtime.elastic import LeftMesh
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.runtime.straggler import StragglerDetector

    model = build_model(cfg, mesh, args.slots)
    B, S = args.slots, args.prompt_len
    max_len = S + args.shared_prefix + args.gen + T
    requests = synthetic_requests(cfg.vocab_size, S, args.gen, args.requests or 2 * B * args.fabric,
                                  args.shared_prefix, prog_spec)
    params = model.init(0)  # this rank's expert slice, cut layer by layer
    injector = FaultInjector(specs) if specs else None
    ckpt, tmpdir = _cli_checkpoint(args, cfg, checkpoint_every)
    ladder = degrade_ladder(tree, T)
    world = dist.get_world_size()
    make = make_replica_factory(cfg, B, max_len, params, ladder, drafter=args.drafter, telemetry=telemetry,
                                fault_hook=injector.check if injector else None,
                                launch_timeout=args.launch_timeout, device=model.device, mesh=mesh, ckpt=ckpt,
                                shrink_to=(max(args.model, world // 2), args.model))
    fabric = ServeFabric(
        make, requests,
        FabricConfig(n_replicas=args.fabric, launch_timeout=args.launch_timeout,
                     checkpoint_every=checkpoint_every, max_degrade_level=len(ladder) - 1,
                     synthetic_step_times=bool(specs)),
        ckpt=ckpt, restore_params=(lambda mgr: mgr.restore(model.device, mesh=mesh)[0]) if ckpt else None,
        params=params, detector=StragglerDetector(n_workers=args.fabric, warmup=8) if args.fabric > 1 else None,
    )
    t0 = time.perf_counter()
    try:
        results = fabric.run()
    except LeftMesh:
        return 0  # a rank past the survivors' mesh stops serving (make_replica_factory)
    except BaseException:
        if tmpdir is not None:
            tmpdir.cleanup()
        raise
    if ckpt is not None and dist.get_world_size() > 1:
        dist.barrier()  # every rank is done with the checkpoints before rank 0 removes them
    if tmpdir is not None:
        tmpdir.cleanup()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if lead:
        _dump_tokens(args.dump_tokens, results)

    st = fabric.stats
    gen = st["accepted"]
    finished = sum(1 for r in results.values() if r.error is None)
    pool = f"{B}" if args.fabric == 1 else f"{args.fabric}x{B}"
    say(f"served {finished} requests on {pool} slots ({model.device}, mesh {mesh.shape}): {gen} tokens in "
        f"{wall * 1e3:.1f} ms ({gen / max(wall, 1e-9):.0f} tok/s, {st['launches']} launches, prefill "
        f"{st['prefill_ms']:.1f} ms total)")
    if T > 1:
        shape = f"tree {args.draft_tree}" if tree is not None else f"width {T}"
        say(f"speculative: {shape} ({T} nodes), drafter {args.drafter}, accept rate "
            f"{st['accepted'] / max(st['drafted'], 1):.2f} ({st['accepted'] / max(st['launches'], 1):.2f} "
            f"tokens/launch)")
    if cfg.paged:
        adm = st["paged_admissions"]
        say(f"paged: {adm} admissions, {st['pages_shared']} pages bound via prefix trie "
            f"({st['pages_shared'] / max(adm, 1):.2f}/admission), {st['admit_copy_rows']} KV rows "
            f"copied at admission")
    if telemetry and st["agreements"]:
        say(f"plan telemetry: stale-vs-fresh top-k agreement mean {np.mean(st['agreements']):.3f} "
            f"min {np.min(st['agreements']):.3f} over {len(st['agreements'])} launches")
    if prog_spec is not None:
        frac = st["prog_mask_frac_sum"] / max(st["prog_mask_cnt"], 1)
        say(f"programs: {st['prog_tokens']} constrained tokens, {st['prog_states_visited']} automaton states "
            f"visited, masked-token fraction {frac:.3f}, {st['forks_started']} forks (live max "
            f"{st['forks_live_max']}, {st['fork_kv_rows_copied']} KV rows copied at fork), "
            f"{st['prog_masked_emissions']} masked emissions")
    if args.fabric > 1 or specs:
        say(f"fabric: {st['crashes']} crashes, {st['rejoins']} rejoins ({st['rewarm_prefills']} re-warm "
            f"prefills, {st['restores']} checkpoint restores), {st['transient_failures']} transient failures "
            f"({st['timeouts']} timeouts, {st['backoff_rounds']} backoff rounds), {st['poisoned']} poisoned, "
            f"{len(st['degradations'])} degradations, {st['excluded']} excluded, {st['dropped']} dropped, "
            f"{st['duplicates']} duplicates")
    unanswered = [r.rid for r in requests if r.rid not in results]
    errors = [r for r in results.values() if r.error is not None]
    poison_expected = any(s.kind == "poison" for s in specs)
    code = 0
    if unanswered or (errors and not poison_expected):
        say(f"SERVE ERROR: unanswered {unanswered}, errors {[(r.rid, r.error) for r in errors]}")
        code = 1
    if st["duplicates"]:
        say(f"SERVE ERROR: {st['duplicates']} duplicate results published")
        code = 1
    if args.expect_shared_pages and st["pages_shared"] == 0:
        say("SERVE ERROR: --expect-shared-pages set but no page was shared across admissions")
        code = 1
    if st["prog_masked_emissions"]:
        say(f"SERVE ERROR: {st['prog_masked_emissions']} tokens emitted outside their automaton's allowed set")
        code = 1
    return code


if __name__ == "__main__":
    sys.exit(main())
