"""Plain PyTorch version of the decode MoE kernel (``csrc/moe_decode.cu``).

For each expert the plan names, the assignments that picked it run one
SwiGLU in f32 and add ``w * y`` into the (T, d) f32 output.  Looping over
the distinct experts (not over all E, not gathering a (T, k, d, f) copy of
the weights) keeps this plain version within memory at full width.  With
``scales`` (gate's, up's, down's (E,) f32 scales, or a (3, E) tensor) the
stacks are int8 and each expert's tiles are dequantized elementwise
(``w * s[e]`` in f32) before any contraction, the order the kernel uses,
so the result is bitwise this function's on the dequantized stacks.
"""
from __future__ import annotations

import torch


def decode_moe(
    x: torch.Tensor,           # (T, d)
    expert_ids: torch.Tensor,  # (T, k) int32
    weights: torch.Tensor,     # (T, k) f32
    w_gate: torch.Tensor,      # (E, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,      # (E, f, d)
    scales=None,  # (gate, up, down) (E,) f32 scales of int8 stacks, or (3, E)
) -> torch.Tensor:
    T, k = expert_ids.shape
    xf = x.to(torch.float32)
    out = torch.zeros((T, x.shape[1]), dtype=torch.float32, device=x.device)
    flat_e = expert_ids.reshape(-1).long()
    flat_w = weights.reshape(-1).to(torch.float32)
    tok = torch.arange(T * k, device=x.device) // k
    for e in torch.unique(flat_e).tolist():
        sel = (flat_e == e).nonzero().squeeze(1)
        rows = xf[tok[sel]]
        wg, wu, wd = (w[e].to(torch.float32) for w in (w_gate, w_up, w_down))
        if scales is not None:
            sg, su, sd = (s[e] for s in scales)
            wg, wu, wd = wg * sg, wu * su, wd * sd
        g = rows @ wg
        u = rows @ wu
        y = (torch.nn.functional.silu(g) * u) @ wd
        out.index_put_((tok[sel],), flat_w[sel, None] * y, accumulate=True)
    return out
