"""The serve launches as plain eager functions (the port's counterpart of
``repro/launch/steps.py``'s ``build_spec_serve_step`` and
``build_admission``, which build jitted, sharded bundles).

CUDA graphs for the decode launch come in a later slice.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.layers import Params


def spec_serve_step(
    model: Model, params: Params, cache: List[Params], tokens: np.ndarray, lengths: np.ndarray,
    prev_accept: np.ndarray,
) -> np.ndarray:
    """One speculative launch: tokens (B, T), lengths (B,), prev_accept (B,)
    -> the model's greedy token per position (B, T), on the host.  The
    argmax runs on the device, so only B*T ids cross to the host; the cache
    is updated in place."""
    logits = model.decode_tokens(params, cache, tokens, lengths, prev_accept)
    return torch.argmax(logits, dim=-1).cpu().numpy()


def admission(model: Model, params: Params, cache: List[Params], prompt: np.ndarray, slot: int) -> torch.Tensor:
    """B=1 prefill of ``prompt`` written straight into batch row ``slot``
    (the reference prefills a fresh B=1 cache and copies it in; the slot
    ends up holding the same rows) -> last-position logits (V,)."""
    return model.prefill(params, np.asarray(prompt)[None], cache, slot=slot)[0]
