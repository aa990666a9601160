"""Symmetric int8 quantization with a float scale: the scale is a control
word (port of ``repro/core/quant.py``).

On the serve plane the per-token KV scales and the per-expert weight scales
ride beside lengths, plans, ancestor words and block tables: the data plane
streams int8, the control plane carries the scales.

``axis=`` selects blockwise scales: the amax reduces over the given axes
(keepdims), so the scale broadcasts against the quantized tensor, e.g.
``axis=(-2, -1)`` on a (B, S, nkv, hd) KV buffer gives one scale per token
row, the unit that speculative rollback and paged CoW move.

The arithmetic is the reference's, step for step: f32 compute, ``amax /
127`` with a scale of 1.0 for an all-zero block, true division (never a
multiply by the reciprocal), round half to even (``torch.round``, as
``jnp.round``), clip to +-127; a blockwise scale comes back in the input's
float type.  ``dequantize_int8`` multiplies in f32 and returns the scale's
type unless ``dtype`` is given.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Axis = Union[int, Tuple[int, ...]]


def quantize_int8(x: torch.Tensor, axis: Optional[Axis] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, scale).  ``axis=None``: one f32 scalar scale;
    ``axis``: amax over those axes with keepdims, the scale in ``x``'s own
    floating type."""
    xf = x.to(torch.float32)
    if axis is None:
        amax = xf.abs().max()
    else:
        amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    if axis is not None and x.dtype.is_floating_point:
        scale = scale.to(x.dtype)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=None) -> torch.Tensor:
    """``q * scale`` computed in f32, returned in ``dtype`` (default: the
    scale's type, the one the quantizer recorded)."""
    out = q.to(torch.float32) * scale.to(torch.float32)
    return out.to(dtype if dtype is not None else scale.dtype)
