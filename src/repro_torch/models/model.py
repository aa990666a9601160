"""Model facade (port of ``repro/models/model.py``): init, cache, prefill
and speculative chain decode for the ``moe``/``attn`` decoder stack.

The cache is updated in place by :meth:`Model.prefill` and
:meth:`Model.decode_tokens`; both return only logits.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params


class Model:
    """``device=None`` means the card; pass ``device="cpu"`` for the plain
    PyTorch path (every kernel wrapper then runs its plain version)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, seed: Union[int, torch.Generator] = 0) -> Params:
        """Random weights drawn on the model's device from a seeded generator."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return T.init_params(self.cfg, gen, self.device)

    def init_cache(self, batch: int, max_len: int) -> List[Params]:
        return T.init_cache(self.cfg, batch, max_len, self.device)

    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        dtype = L.act_dtype(self.cfg)
        x = L.embed(tokens, params["embed"], dtype)
        return x * torch.sqrt(torch.tensor(float(self.cfg.d_model), dtype=torch.float32)).to(dtype)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, params["final_norm"])
        table = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        return L.unembed(x, table)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, tokens, cache: List[Params], slot: int = 0) -> torch.Tensor:
        """Run the (B, S) prompt(s) and write their K/V and seeded plans into
        batch rows ``[slot, slot + B)`` of ``cache`` in place (admission
        writes a B=1 prefill straight into its slot); returns the
        last-position logits (B, V)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = self._embed(params, tokens)
        route_src = x  # layer-0 control-plane source = embeddings
        rows = slice(slot, slot + B)
        for kind, p, c in zip(self.cfg.layer_kinds, params["layers"], cache):
            x, route_src = T.apply_layer_prefill(x, route_src, p, c, kind, self.cfg, positions, rows)
        return self.logits(params, x[:, -1:, :])[:, 0]

    @torch.no_grad()
    def decode_tokens(
        self,
        params: Params,
        cache: List[Params],
        tokens,                 # (B, T): last accepted token + T-1 chain drafts
        lengths,                # (B,) per-sequence tokens already in the cache
        prev_accept=None,       # (B,) plan-row select
    ) -> torch.Tensor:
        """One speculative chain launch over a ragged batch: token (b, t)
        sits at position ``lengths[b] + t``; returns logits (B, T, V) that
        score each position's successor.  ``prev_accept`` selects the
        cached plan row routed from the position the previous launch's
        verification accepted last (rollback-exact plan carry)."""
        tokens = self._tokens(tokens)
        B, Tn = tokens.shape
        lengths = np.asarray(lengths, np.int64).reshape(B)
        max_len = cache[0]["k"].shape[1]
        if lengths.min() < 0 or lengths.max() + Tn > max_len:
            raise ValueError(f"positions up to {lengths.max() + Tn - 1} fall outside the cache of {max_len} rows")
        lengths_t = torch.as_tensor(lengths, device=self.device)
        prev = np.zeros((B,), np.int64) if prev_accept is None else np.asarray(prev_accept, np.int64).reshape(B)
        if prev.min() < 0 or prev.max() >= max(self.cfg.spec_tokens, 1):
            raise ValueError(f"prev_accept {prev.tolist()} selects no row of a {self.cfg.spec_tokens}-row plan vector")
        prev_t = torch.as_tensor(prev, device=self.device)
        x = self._embed(params, tokens)
        route_src = x
        for kind, p, c in zip(self.cfg.layer_kinds, params["layers"], cache):
            x, route_src = T.apply_layer_decode_spec(x, route_src, p, c, kind, self.cfg, lengths_t, prev_t)
        return self.logits(params, x)

    # ------------------------------------------------------------------
    @staticmethod
    def write_cache_slot(cache: List[Params], one_cache: List[Params], slot: int) -> None:
        """Copy a B=1 cache (every leaf) into batch row ``slot``, in place."""
        for c, o in zip(cache, one_cache):
            for name, leaf in c.items():
                leaf[slot].copy_(o[name][0])
