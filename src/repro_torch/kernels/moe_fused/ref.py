"""Plain PyTorch versions of the fused prefill MoE kernels
(``csrc/moe_fused.cu``): gather -> batched gate/up + SwiGLU, and batched
down projection -> weighted scatter-add, over the same flat slot-major
control words; and of their backward (``csrc/moe_fused_bwd.cu``).
Products run in f32."""
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


def down_combine_bwd(
    dy: torch.Tensor,        # (T, d) f32
    h: torch.Tensor,         # (E, C, f)
    w_down: torch.Tensor,    # (E, f, d)
    flat_idx: torch.Tensor,  # (E*C,) int32, T = empty
    slot_w: torch.Tensor,    # (E*C,) f32
):
    """(dh, dw_down, dslot_w) of :func:`down_combine`; an empty slot gets zeros."""
    E, C, f = h.shape
    d = w_down.shape[-1]
    T = dy.shape[0]
    occ = (flat_idx < T).reshape(E, C, 1)
    rows = torch.cat([dy.to(torch.float32), dy.new_zeros((1, d), dtype=torch.float32)])[flat_idx.long()]
    q = torch.bmm(rows.reshape(E, C, d), w_down.to(torch.float32).transpose(1, 2))  # dy[idx] Wd^T
    w = torch.where(occ, slot_w.reshape(E, C, 1).to(torch.float32), torch.zeros((), dtype=torch.float32))
    dh = w * q
    dwd = torch.bmm(h.to(torch.float32).transpose(1, 2), w * rows.reshape(E, C, d))
    dsw = torch.where(occ, (h.to(torch.float32) * q).sum(-1, keepdim=True), torch.zeros((), dtype=torch.float32))
    return dh.to(h.dtype), dwd.to(w_down.dtype), dsw.reshape(E * C)


def gather_swiglu_bwd(
    dh: torch.Tensor,         # (E, C, f)
    x: torch.Tensor,          # (T, d)
    flat_idx: torch.Tensor,   # (E*C,) int32, T = empty
    flat_cidx: torch.Tensor,  # (T*k,) int32, E*C = dropped
    w_gate: torch.Tensor,     # (E, d, f)
    w_up: torch.Tensor,
):
    """(dx, dw_gate, dw_up) of :func:`gather_swiglu`: g and u recomputed,
    dx summed over each token's assignments."""
    E, d, f = w_gate.shape
    C = flat_idx.shape[0] // E
    T = x.shape[0]
    k = flat_cidx.numel() // T
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0).to(torch.float32)
    xs = x_pad[flat_idx.long()].reshape(E, C, d)
    wg, wu = w_gate.to(torch.float32), w_up.to(torch.float32)
    g, u = torch.bmm(xs, wg), torch.bmm(xs, wu)
    sg = torch.sigmoid(g)
    dhf = torch.where((flat_idx < T).reshape(E, C, 1), dh.to(torch.float32), torch.zeros((), dtype=torch.float32))
    dg = dhf * u * (sg * (1.0 + g * (1.0 - sg)))
    du = dhf * (g * sg)
    xt = xs.transpose(1, 2)
    dwg, dwu = torch.bmm(xt, dg), torch.bmm(xt, du)
    dxs = torch.bmm(dg, wg.transpose(1, 2)) + torch.bmm(du, wu.transpose(1, 2))
    dxs = torch.cat([dxs.reshape(E * C, d), dxs.new_zeros((1, d))])
    dx = dxs[flat_cidx.long()].reshape(T, k, d).sum(1)
    return dx.to(x.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype)
