"""Serving driver of the port: one continuous-batching replica with chain
speculation on the Agile decode plane (port of ``repro/launch/serve.py``'s
``ServeReplica`` without programs, forks, paging, fault hooks or the model
drafter).

Each :meth:`ServeReplica.step` runs ``spec_tokens`` tokens for every slot in
ONE model call; between launches the host verifies each slot's draft
greedily (rejected cache rows are overwritten by the next launch; the plan
row the next launch consumes is selected by ``prev_accept``) and buffers
accepted tokens per request until the request completes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \\
        --smoke --decode-plane --spec-tokens 4 --device cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.plans import TreePlan
from repro_torch.launch.speculative import TREE_DRAFTERS, greedy_accept_tree
from repro_torch.launch.steps import admission, spec_serve_step
from repro_torch.models.model import Model

DRAFTER_CHOICES = ("ngram", "repeat")


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
    card (see :func:`repro_torch.resolve_device`)."""

    def __init__(self, cfg, slots: int, max_len: int, params, *, drafter: str = "ngram", device=None):
        if drafter not in TREE_DRAFTERS:
            raise ValueError(f"drafter must be one of {sorted(TREE_DRAFTERS)}, got {drafter!r}")
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.params = params
        self.B, self.max_len = slots, max_len
        self.T = max(cfg.spec_tokens, 1)
        self.cache = self.model.init_cache(slots, max_len)
        self._tree = TreePlan.chain(self.T)
        self._fill = TREE_DRAFTERS[drafter]

        B = slots
        self.lengths = np.zeros((B,), np.int32)
        self.prev_accept = np.zeros((B,), np.int32)
        self.last_tok = np.zeros((B,), np.int32)
        self.gen_left = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.history: List[List[int]] = [[] for _ in range(B)]
        self.requests: List[Optional[Request]] = [None] * B
        self.emitted: List[List[int]] = [[] for _ in range(B)]

        self.launches = 0
        self.prefills = 0
        self.accepted_total = 0
        self.drafted_total = 0
        self.prefill_ms = 0.0
        self.decode_ms = 0.0

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [b for b in range(self.B) if not self.active[b]]

    def has_work(self) -> bool:
        return bool(self.active.any())

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
        t0 = time.perf_counter()
        logits = admission(self.model, self.params, self.cache, req.prompt, b)
        first = int(torch.argmax(logits))
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        self.prefills += 1
        self.lengths[b] = len(req.prompt)
        self.last_tok[b] = first
        self.prev_accept[b] = 0
        self.gen_left[b] = req.gen
        self.active[b] = True
        self.history[b] = [first]
        self.requests[b] = req
        self.emitted[b] = [first]
        return b

    def step(self) -> List[Result]:
        """One speculative launch over the pool: draft, decode, greedy
        verify/rollback; returns the requests that completed."""
        if not self.active.any():
            return []
        T, B = self.T, self.B
        toks = np.zeros((B, T), np.int32)
        for b in range(B):
            if self.active[b] and T > 1:
                toks[b] = self._fill(self.history[b], int(self.last_tok[b]), self._tree)
        toks[:, 0] = self.last_tok

        t0 = time.perf_counter()
        y = spec_serve_step(self.model, self.params, self.cache, toks, self.lengths, self.prev_accept)
        self.decode_ms += (time.perf_counter() - t0) * 1e3
        self.launches += 1

        done: List[Result] = []
        for b in range(B):
            if not self.active[b]:
                self.lengths[b] = 0  # park finished slots at depth 0
                continue
            path = greedy_accept_tree(toks[b], y[b], self._tree, int(self.gen_left[b]))
            a = len(path)
            accepted = [int(y[b, p]) for p in path]
            self.prev_accept[b] = path[-1]
            self.history[b].extend(accepted)
            self.emitted[b].extend(accepted)
            self.accepted_total += a
            self.drafted_total += T
            self.gen_left[b] -= a
            self.last_tok[b] = accepted[-1]
            self.lengths[b] += a
            if self.gen_left[b] <= 0 or self.lengths[b] + T > self.max_len:
                req = self.requests[b]
                done.append(Result(rid=req.rid, tokens=list(self.emitted[b]), replica=0))
                self.active[b] = False
                self.requests[b] = None
                self.emitted[b] = []
        return done


# ---------------------------------------------------------------------------
# queue, admission loop, CLI
# ---------------------------------------------------------------------------


def synthetic_requests(vocab_size: int, prompt_len: int, gen: int, n_req: int) -> List[Request]:
    """The reference CLI's synthetic ragged queue (same seed, same draws):
    prompts cycle through three length buckets."""
    S = prompt_len
    buckets = sorted({max(4, S // 2), max(4, (3 * S) // 4), S})
    rng = np.random.default_rng(0)
    rng.integers(0, vocab_size, size=0)  # the reference's (empty) shared prefix draw
    return [
        Request(
            rid=i,
            prompt=np.asarray(rng.integers(0, vocab_size, size=buckets[i % len(buckets)]), np.int32),
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
    ap.add_argument("--slots", type=int, default=4, help="decode slot pool size")
    ap.add_argument("--prompt-len", type=int, default=64, help="max synthetic prompt length")
    ap.add_argument("--gen", type=int, default=16, help="tokens to generate per request")
    ap.add_argument("--requests", type=int, default=0, help="queued requests (default 2x slots)")
    ap.add_argument("--decode-plane", action="store_true", help="serve decode on the Agile decode plane")
    ap.add_argument("--spec-tokens", type=int, default=1, help="tokens per decode launch")
    ap.add_argument("--drafter", choices=DRAFTER_CHOICES, default="ngram")
    ap.add_argument("--dump-tokens", default="", help="write {rid: token stream} JSON here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    T = max(args.spec_tokens, 1)
    cfg = dataclasses.replace(cfg, decode_plane=args.decode_plane or cfg.decode_plane, spec_tokens=T)
    model = Model(cfg, args.device)
    B, S = args.slots, args.prompt_len
    max_len = S + args.gen + T
    requests = synthetic_requests(cfg.vocab_size, S, args.gen, args.requests or 2 * B)
    params = model.init(0)
    rep = ServeReplica(cfg, B, max_len, params, drafter=args.drafter, device=model.device)
    t0 = time.perf_counter()
    results = serve_queue(rep, requests)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _dump_tokens(args.dump_tokens, results)

    gen = rep.accepted_total
    finished = sum(1 for r in results.values() if r.error is None)
    print(f"served {finished} requests on {B} slots ({model.device}): {gen} tokens in {wall * 1e3:.1f} ms "
          f"({gen / max(wall, 1e-9):.0f} tok/s, {rep.launches} launches, prefill {rep.prefill_ms:.1f} ms total)")
    if T > 1:
        print(f"speculative: width {T}, drafter {args.drafter}, accept rate "
              f"{rep.accepted_total / max(rep.drafted_total, 1):.2f} "
              f"({rep.accepted_total / max(rep.launches, 1):.2f} tokens/launch)")
    unanswered = [r.rid for r in requests if r.rid not in results]
    errors = [r for r in results.values() if r.error is not None]
    if unanswered or errors:
        print(f"SERVE ERROR: unanswered {unanswered}, errors {[(r.rid, r.error) for r in errors]}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
