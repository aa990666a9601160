"""Serving driver of the port: one continuous-batching replica with chain
or tree speculation on the Agile decode plane, over a contiguous or a paged
KV cache, over rolling-window caches and RG-LRU state for the hybrid
RecurrentGemma family, or over SSD state for the Mamba-2 family, both at
spec width 1 on the contiguous plane (port of ``repro/launch/serve.py``'s
``ServeReplica`` without programs, forks, fault hooks or the fabric).

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

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --paged --page-size 8 --draft-tree 2,1 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --smoke --decode-plane --prompt-len 48 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --smoke --decode-plane --prompt-len 40 --device cpu

The quantized bandwidth plane (``--kv-dtype int8``: int8 KV rows with
per-token scales; ``--expert-dtype int8``: decode reads int8 twins of the
expert stacks with per-expert scales) serves every one of these planes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --spec-tokens 4 --kv-dtype int8 --expert-dtype int8 --device cpu

Expert parallelism (``--model N``): the replica's MoE layers run on a
``(data, model)`` mesh (:mod:`repro_torch.launch.mesh`), the experts split
over the ``model`` axis: the a2a body at prefill, the shard-sliced plan and
one all-reduce a layer at decode (both skipped at one rank)
(:mod:`repro_torch.parallel.moe_parallel`).  ``--model 1`` (the default)
makes a one-rank group in-process; ``--model N > 1`` runs under ``torchrun
--nproc-per-node N``, every rank serving the same queue and rank 0 printing
and dumping:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pages import PageTable, PrefixTrie, commit_maps
from repro_torch.core.plans import TreePlan
from repro_torch.launch.mesh import backend_for, init_single_rank, make_host_mesh, rank_device
from repro_torch.launch.speculative import TREE_DRAFTERS, ModelDrafter, greedy_accept_tree
from repro_torch.launch.steps import GraphPool, TreeCommit, admission, build_model, build_spec_serve_step, prefill_model
from repro_torch.models.transformer import check_spec_width, max_pages_for, num_pages

DRAFTER_CHOICES = ("model", "ngram", "repeat")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any  # 1-D int32 array of prompt token ids
    gen: int     # tokens to generate after the prefill token


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]           # prefill token + generated tokens (empty on error)
    replica: int = -1
    error: Optional[str] = None


class RequestRejected(Exception):
    """A request that can never finish within the slot budget."""


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
    rank of the mesh serves the same queue.  ``drafter="model"`` drafts with
    a 1-layer model of the same family (``model_drafter``, its weights
    ``drafter_params``, or drawn from seed 7); ``telemetry`` records the
    plan agreement of every launch in ``agreements``.

    Every decode launch, the contiguous tree commit and the model drafter's
    launches are compiled launches (:mod:`repro_torch.launch.steps`): on
    the card each is captured once in a CUDA graph, all of one replica's
    graphs sharing one memory pool, and replayed; on the CPU each runs
    eagerly on its static buffers.  Admission is always eager: prompt
    lengths vary.  :meth:`reset` returns a drained replica to its state at
    construction, graphs kept."""

    def __init__(self, cfg, slots: int, max_len: int, params, *, tree: Optional[TreePlan] = None,
                 drafter: str = "ngram", telemetry: bool = False, drafter_params=None, device=None,
                 mesh=None):
        if drafter not in DRAFTER_CHOICES:
            raise ValueError(f"drafter must be one of {sorted(DRAFTER_CHOICES)}, got {drafter!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.model = build_model(cfg, mesh, slots, device)
        self._pf_model = prefill_model(self.model)
        self.params = params
        self.B, self.max_len = slots, max_len
        self.T = max(cfg.spec_tokens, 1)
        check_spec_width(cfg, self.T)
        if tree is not None and tree.num_nodes != self.T:
            raise ValueError(f"tree has {tree.num_nodes} nodes but cfg.spec_tokens is {self.T}")
        self.tree = tree
        self._branchy = tree is not None and not tree.is_chain()
        self.telemetry = telemetry and cfg.decode_plane and cfg.is_moe
        self.cache = self.model.init_cache(slots, max_len)
        self.paged = bool(cfg.paged)
        self.graphs = GraphPool(self.model.device) if self.model.device.type == "cuda" else None
        self._decode = build_spec_serve_step(self.model, params, self.cache, batch=slots, tree=tree,
                                             telemetry=self.telemetry, max_len=max_len, graphs=self.graphs)
        self._commit = None
        if self._branchy and not self.paged:
            self._commit = TreeCommit(self.cache, batch=slots, T=self.T, graphs=self.graphs)
        self._propose_tree = tree if tree is not None else TreePlan.chain(self.T)
        self._fill = TREE_DRAFTERS.get(drafter, TREE_DRAFTERS["ngram"])
        self.model_drafter = None
        if drafter == "model" and self.T > 1:
            # same family, one layer, width-1 launches, its own contiguous cache
            draft_cfg = dataclasses.replace(cfg, num_layers=1, spec_tokens=1, paged=False)
            draft_model = build_model(draft_cfg, mesh, slots, self.model.device)
            dp = drafter_params if drafter_params is not None else draft_model.init(7)
            self.model_drafter = ModelDrafter(draft_model, dp, slots, max_len, graphs=self.graphs)

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
        self._zero_counters()

    def _zero_counters(self) -> None:
        self.launches = 0
        self.prefills = 0
        self.commits = 0  # contiguous tree-commit passes (the paged plane makes none)
        self.commit_moves = 0  # accepted tree nodes off their committed row: one row move each
        self.accepted_total = 0
        self.drafted_total = 0
        self.agreements: List[float] = []
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
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
        Raises if a request is still in a slot."""
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

    def admit(self, req: Request) -> int:
        """Prefill ``req`` into the first free slot; returns the slot."""
        if len(req.prompt) + req.gen + self.T > self.max_len:
            raise RequestRejected(
                f"prompt len {len(req.prompt)} + gen {req.gen} + spec width "
                f"{self.T} exceeds the slot budget {self.max_len}"
            )
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        b = free[0]
        prompt = np.asarray(req.prompt, np.int32)
        t0 = time.perf_counter()
        rows = self._bind_pages(b, prompt) if self.paged else None
        logits = admission(self.model, self.params, self.cache, prompt, b, rows, self._pf_model)
        first = int(torch.argmax(logits))
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        self.prefills += 1
        self.lengths[b] = len(prompt)
        self.last_tok[b] = first
        self.prev_accept[b] = 0
        self.gen_left[b] = req.gen
        self.active[b] = True
        self.history[b] = [first]
        self.requests[b] = req
        self.emitted[b] = [first]
        if self.model_drafter is not None:
            self.model_drafter.admit(b, prompt)
        return b

    def step(self) -> List[Result]:
        """One speculative launch over the pool: draft, decode, greedy
        verify/rollback, tree commit; returns the requests that completed."""
        if not self.active.any():
            return []
        T, B = self.T, self.B
        if self.model_drafter is not None:
            self.model_drafter.catch_up()
            toks = self.model_drafter.propose(self.last_tok, self.lengths, self._propose_tree)
        else:
            toks = np.zeros((B, T), np.int32)
            for b in range(B):
                if self.active[b] and T > 1:
                    toks[b] = self._fill(self.history[b], int(self.last_tok[b]), self._propose_tree)
        toks[:, 0] = self.last_tok

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
        y, agree = self._decode(toks, self.lengths, self.prev_accept, pages=pages, commit=commit)
        self.decode_ms += (time.perf_counter() - t0) * 1e3
        self.launches += 1
        if self.telemetry:
            self.agreements.append(agree)

        path_pad = np.tile(np.arange(T, dtype=np.int32), (B, 1))
        acc_n = np.zeros((B,), np.int32)
        for b in range(B):
            if not self.active[b]:
                self.lengths[b] = 0  # park finished slots at depth 0
                continue
            path = greedy_accept_tree(toks[b], y[b], self._propose_tree, int(self.gen_left[b]))
            a = len(path)
            path_pad[b, :a] = path
            self.commit_moves += sum(int(p != i) for i, p in enumerate(path))
            accepted = [int(y[b, p]) for p in path]
            self.prev_accept[b] = path[-1]
            if self.model_drafter is not None:
                # rows [lengths, lengths + a) of the true stream: the launch
                # input followed by all but the last accepted token
                self.model_drafter.observe(b, [int(self.last_tok[b])] + accepted[:-1])
            self.history[b].extend(accepted)
            self.emitted[b].extend(accepted)
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
                self._commit(self.lengths, path_pad)
                self.commits += 1

        done: List[Result] = []
        for b in range(B):
            if not self.active[b]:
                continue
            self.lengths[b] += acc_n[b]
            if self.gen_left[b] <= 0 or self.lengths[b] + T > self.max_len:
                req = self.requests[b]
                done.append(Result(rid=req.rid, tokens=list(self.emitted[b]), replica=0))
                self._retire_slot(b)
        return done

    def _retire_slot(self, b: int) -> None:
        """Release slot ``b``: pages recycled and its pending commit voided
        (its freed pages may be bound again before the next launch)."""
        self.active[b] = False
        self.requests[b] = None
        self.emitted[b] = []
        if self.paged:
            self.pager.free_slot(b)
            if self._pending_commit is not None:
                self._pending_commit[0][b] = -1
                self._pending_commit[1][b] = -1


# ---------------------------------------------------------------------------
# queue, admission loop, CLI
# ---------------------------------------------------------------------------


def synthetic_requests(vocab_size: int, prompt_len: int, gen: int, n_req: int,
                       shared_prefix: int = 0) -> List[Request]:
    """The reference CLI's synthetic ragged queue (same seed, same draws):
    one shared system prompt of ``shared_prefix`` tokens is drawn first and
    heads every prompt; the rest cycle through three length buckets."""
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
        )
        for i in range(n_req)
    ]


def serve_queue(rep: ServeReplica, requests: List[Request]) -> Dict[int, Result]:
    """Admit from the queue front into free slots, step until every request
    is answered; one replica's share of the reference fabric's loop."""
    queue = deque(requests)
    results: Dict[int, Result] = {}
    while queue or rep.has_work():
        while queue and rep.free_slots():
            req = queue[0]
            try:
                rep.admit(req)
            except RequestRejected as err:
                results[req.rid] = Result(rid=req.rid, tokens=[], replica=0, error=str(err))
            queue.popleft()
        for res in rep.step():
            results[res.rid] = res
    return results


def _dump_tokens(path: str, results: Dict[int, Result]) -> None:
    """Write {rid: token stream} JSON for cross-run stream-identity diffs."""
    if not path:
        return
    with open(path, "w") as f:
        json.dump({str(rid): list(map(int, r.tokens)) for rid, r in sorted(results.items())}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4, help="decode slot pool size")
    ap.add_argument("--prompt-len", type=int, default=64, help="max synthetic prompt length")
    ap.add_argument("--gen", type=int, default=16, help="tokens to generate per request")
    ap.add_argument("--requests", type=int, default=0, help="queued requests (default 2x slots)")
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
    ap.add_argument("--device", default=None, help="cuda (default: cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel mesh axis (1 in this slice: batch sharding comes later)")
    ap.add_argument("--model", type=int, default=1,
                    help="expert-parallel mesh axis: ranks the experts split over (N > 1 under torchrun)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config

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
    if "ssm" in cfg.layer_kinds and (args.paged or args.draft_tree):
        ap.error("Mamba-2 (ssm) archs serve on the contiguous decode plane at spec width 1; "
                 "--paged and --draft-tree for them come in a later slice")
    try:
        check_spec_width(cfg, T)
    except NotImplementedError as err:
        ap.error(str(err))
    telemetry = args.telemetry and cfg.decode_plane and cfg.is_moe
    if args.data != 1:
        ap.error("--data > 1 (batch sharding over the data axis) comes in a later slice; serve with --data 1")
    if args.model < 1:
        ap.error(f"--model must be >= 1, got {args.model}")
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if (world or 1) != args.data * args.model:
        ap.error(f"a ({args.data}, {args.model}) mesh runs one rank per process: launch it with "
                 f"torchrun --nproc-per-node {args.data * args.model} (WORLD_SIZE is {world or 'unset'})")
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    own_group = not dist.is_initialized()
    if own_group:
        if world:
            dist.init_process_group(backend_for(device), init_method="env://")
        else:
            init_single_rank(device)
    try:
        return _serve_cli(args, cfg, tree, T, telemetry, make_host_mesh(args.data, args.model, device))
    finally:
        if own_group:
            dist.destroy_process_group()


def _serve_cli(args, cfg, tree: Optional[TreePlan], T: int, telemetry: bool, mesh) -> int:
    """The CLI's serving run on this rank of ``mesh``; rank 0 prints and dumps."""
    lead = dist.get_rank() == 0
    model = build_model(cfg, mesh, args.slots)
    B, S = args.slots, args.prompt_len
    max_len = S + args.shared_prefix + args.gen + T
    requests = synthetic_requests(cfg.vocab_size, S, args.gen, args.requests or 2 * B, args.shared_prefix)
    params = model.init(0)  # this rank's expert slice, cut layer by layer
    rep = ServeReplica(cfg, B, max_len, params, tree=tree, drafter=args.drafter, telemetry=telemetry, mesh=mesh)
    t0 = time.perf_counter()
    results = serve_queue(rep, requests)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say = print if lead else (lambda *a, **k: None)
    if lead:
        _dump_tokens(args.dump_tokens, results)

    gen = rep.accepted_total
    finished = sum(1 for r in results.values() if r.error is None)
    say(f"served {finished} requests on {B} slots ({model.device}, mesh {mesh.shape}): {gen} tokens in "
        f"{wall * 1e3:.1f} ms ({gen / max(wall, 1e-9):.0f} tok/s, {rep.launches} launches, prefill "
        f"{rep.prefill_ms:.1f} ms total)")
    if T > 1:
        shape = f"tree {args.draft_tree}" if tree is not None else f"width {T}"
        say(f"speculative: {shape} ({T} nodes), drafter {args.drafter}, accept rate "
            f"{rep.accepted_total / max(rep.drafted_total, 1):.2f} "
            f"({rep.accepted_total / max(rep.launches, 1):.2f} tokens/launch)")
    shared = 0
    if cfg.paged:
        st = rep.paged_stats()
        shared = st["pages_shared_total"]
        say(f"paged: {st['admissions']} admissions, {shared} pages bound via prefix trie "
            f"({st['pages_shared_per_admission']:.2f}/admission), {st['admit_copy_rows']} KV rows "
            f"copied at admission")
    if telemetry and rep.agreements:
        say(f"plan telemetry: stale-vs-fresh top-k agreement mean {np.mean(rep.agreements):.3f} "
            f"min {np.min(rep.agreements):.3f} over {len(rep.agreements)} launches")
    unanswered = [r.rid for r in requests if r.rid not in results]
    errors = [r for r in results.values() if r.error is not None]
    if unanswered or errors:
        say(f"SERVE ERROR: unanswered {unanswered}, errors {[(r.rid, r.error) for r in errors]}")
        return 1
    if args.expect_shared_pages and shared == 0:
        say("SERVE ERROR: --expect-shared-pages set but no page was shared across admissions")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
