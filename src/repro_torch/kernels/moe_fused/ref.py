"""Plain PyTorch versions of the fused prefill MoE kernels
(``csrc/moe_fused.cu``): gather -> batched gate/up + SwiGLU, and batched
down projection -> weighted scatter-add, over the same flat slot-major
control words.  Products run in f32."""
from __future__ import annotations

import torch


def gather_swiglu(
    x: torch.Tensor,         # (T, d)
    flat_idx: torch.Tensor,  # (E*C,) int32, T = empty
    w_gate: torch.Tensor,    # (E, d, f)
    w_up: torch.Tensor,
) -> torch.Tensor:
    E, d, f = w_gate.shape
    C = flat_idx.shape[0] // E
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0).to(torch.float32)
    slots = x_pad[flat_idx.long()].reshape(E, C, d)
    g = torch.bmm(slots, w_gate.to(torch.float32))
    u = torch.bmm(slots, w_up.to(torch.float32))
    return (torch.nn.functional.silu(g) * u).to(x.dtype)


def down_combine(
    h: torch.Tensor,         # (E, C, f)
    w_down: torch.Tensor,    # (E, f, d)
    flat_idx: torch.Tensor,  # (E*C,) destination token per slot, T = empty
    slot_w: torch.Tensor,    # (E*C,) f32
    num_tokens: int,
) -> torch.Tensor:
    E, C, f = h.shape
    d = w_down.shape[-1]
    y_slots = torch.bmm(h.to(torch.float32), w_down.to(torch.float32)).reshape(E * C, d)
    y = torch.zeros((num_tokens + 1, d), dtype=torch.float32, device=h.device)
    y.index_put_((flat_idx.long(),), slot_w[:, None].to(torch.float32) * y_slots, accumulate=True)
    return y[:num_tokens]
