"""Data pipeline (the port's copy of ``repro/data/pipeline.py``):
deterministic synthetic LM streams and file-backed token bins, placed on
one device with background host prefetch.

Determinism contract: batch contents are a pure function of (seed, step),
the same numpy arrays the reference's datasets make, so a restart replays
the exact stream from any step.  The loader takes a device instead of a
mesh: on the card each batch is pinned on the prefetch thread and copied
with ``non_blocking`` on the caller's stream.  On a mesh each data rank
passes ``rows``, its rows of the deterministic global batch in
``batch_spec``'s row order (:func:`repro_torch.launch.steps.batch_rows`),
and places only those.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


class MarkovLMDataset:
    """Synthetic token stream with learnable structure: a random sparse
    first-order Markov chain over the vocabulary (so cross-entropy has a
    meaningful floor well below log V, and smoke training visibly learns).
    """

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0, branching: int = 4):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # each token has `branching` likely successors
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, branching))

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = batch_size, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=B)
        choices = rng.integers(0, self._succ.shape[1], size=(B, S))
        resets = rng.random((B, S)) < 0.05  # 5% random jumps
        jumps = rng.integers(0, self.vocab_size, size=(B, S))
        for t in range(1, S):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(resets[:, t], jumps[:, t], nxt)
        return {"tokens": toks}


class FileTokenDataset:
    """Memory-mapped flat token bin (uint16/uint32) chunked into sequences."""

    def __init__(self, path: str | Path, seq_len: int, *, dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.seed = seed
        self.n_seqs = len(self.tokens) // seq_len

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n_seqs, size=batch_size)
        out = np.stack(
            [self.tokens[i * self.seq_len : (i + 1) * self.seq_len] for i in idx]
        ).astype(np.int32)
        return {"tokens": out}


class ShardedLoader:
    """Places (seed, step)-deterministic host batches on ``device``,
    prefetching ``prefetch`` steps ahead on a worker thread (the step never
    waits on numpy).  ``frontend_spec`` (tokens, dim) adds the reference's
    frontend stub: ``default_rng((123, step))`` normal features, f32.
    ``next`` gives ``(step, {name: tensor})``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        device,
        *,
        start_step: int = 0,
        prefetch: int = 2,
        frontend_spec: Optional[Tuple[int, int]] = None,  # (tokens, dim) stub
        rows: Optional[slice] = None,  # this rank's rows of the global batch
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.frontend_spec = frontend_spec
        self.rows = rows
        self._prefetch = max(prefetch, 1)
        self._start(start_step)

    def _start(self, step: int) -> None:
        self._step = step
        self._q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(self._stop, self._q), daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        b = self.dataset.batch(step, self.batch_size)
        if self.frontend_spec:
            ft, fd = self.frontend_spec
            rng = np.random.default_rng((123, step))
            b["frontend"] = rng.standard_normal((self.batch_size, ft, fd)).astype(np.float32)
        if self.rows is not None:
            b = {k: np.ascontiguousarray(v[self.rows]) for k, v in b.items()}
        return b

    def _worker(self, stop: threading.Event, q: queue.Queue) -> None:
        step = self._step
        pin = self.device.type == "cuda"
        while not stop.is_set():
            batch = {k: torch.from_numpy(v) for k, v in self._make(step).items()}
            if pin:
                batch = {k: v.pin_memory() for k, v in batch.items()}
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, host_batch = self._q.get()
        return step, {k: v.to(self.device, non_blocking=True) for k, v in host_batch.items()}

    def __iter__(self) -> Iterator:
        return self

    def seek(self, step: int) -> None:
        """Restart the stream at `step` (checkpoint resume)."""
        self.close()
        self._start(step)

    def close(self) -> None:
        """Stop the worker and wait for it: a worker left inside
        ``pin_memory`` when the interpreter exits aborts the process."""
        self._stop.set()
        self._thread.join()
