"""Model configuration and the arch registry of the PyTorch port.

A copy of ``repro/configs/base.py``'s :class:`ModelConfig`, registry and
``shrink``: the port keeps its own copy so that it imports nothing of the
JAX package.  Field names and defaults are the reference's, so a config
built by either package describes the same model.  Shape cells and the
other archs come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-stack model configuration.

    ``block_pattern`` gives the repeating super-block, e.g. ``("attn",)`` for a
    dense transformer, ``("rec", "rec", "attn")`` for RecurrentGemma,
    ``("ssm",)`` for Mamba-2.  ``num_layers`` counts *layers* (pattern is
    cycled and truncated).
    """

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention details ----------------------------------------------------
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attention_kind: str = "full"  # full | local
    local_window: int = 0  # for attention_kind == "local"
    tie_embeddings: bool = False

    # -- block pattern ---------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)

    # -- MoE -------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # every k-th layer is MoE (1 = all)
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    route_mode: str = "lookahead"  # dense | sync | lookahead  (control plane)
    # Agile decode plane: serve decode through the tiny-T control/data plane
    # (DecodePlan carried in the KV cache, capacity-sort-free dispatch, and
    # valid-prefix attention) instead of reusing the prefill-shaped plane per
    # token.  See models/transformer.apply_layer_decode + kernels/moe_decode.
    decode_plane: bool = False
    # Speculative decode width: tokens per decode launch (draft length + 1).
    # With spec_tokens > 1 the decode cache carries a plan VECTOR (one
    # DecodePlan row per draft position) so the verify/rollback step can
    # select the plan matching the accepted prefix — see
    # models/model.decode_tokens and launch/serve.py's continuous-batching
    # loop.  1 = plain one-token-per-launch decode (PR 2 semantics).
    spec_tokens: int = 1
    # Paged KV plane: full-attention KV lives in a shared pool of fixed-size
    # pages addressed through a per-slot block table (a host control word on
    # the same scalar-prefetch path as DecodePlan/TreePlan).  Admission becomes
    # page assignment (+ prefix-trie sharing) instead of a stripe copy, and
    # tree commit becomes row moves inside the boundary page fused into the
    # next decode launch.  Rolling (modulo-addressed) local-attention caches
    # stay unpaged — their byte bound is the window, not max_len.
    paged: bool = False
    page_size: int = 16

    # -- recurrent (RG-LRU) ----------------------------------------------------
    lru_width: int = 0
    conv1d_width: int = 4

    # -- SSM (Mamba-2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # -- modality frontend (stub per spec) --------------------------------------
    frontend: Optional[str] = None  # vision_stub | audio_stub
    frontend_dim: int = 0
    frontend_tokens: int = 0  # patches / conditioning frames prepended

    # -- numerics / training ----------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Quantized bandwidth plane (serve): "" = full precision, "int8" = store
    # KV (per-token symmetric scales, dequantized in-kernel after the tile
    # load) / decode expert stacks (per-expert scales read from SMEM next to
    # the plan's expert ids) in int8.  The scales are control words on the
    # same scalar-prefetch path as lengths / plans / ancestor masks / block
    # tables — see core/quant.py and docs/architecture.md.
    kv_dtype: str = ""
    expert_dtype: str = ""
    optimizer: str = "adamw"  # adamw | adafactor
    remat: bool = True
    use_pallas: bool = False  # kernels are TPU-target; interpret-mode in tests
    # analysis twins: unroll inner scans (KV blocks / SSD chunks) so that
    # compiled cost_analysis is exact — lax.scan bodies are otherwise counted
    # once by HloCostAnalysis regardless of trip count (see launch/dryrun.py)
    analysis_unroll: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, pattern cycled to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True if sequence mixing cost is sub-quadratic in seq_len (long_500k OK).

        "moe" layers carry the same attention sub-block as "attn" layers.
        """
        kinds = set(self.layer_kinds)
        if kinds & {"attn", "moe"} and self.attention_kind == "full":
            return False
        return True

    # -- parameter counting (for roofline MODEL_FLOPS) -------------------------
    def param_counts(self) -> Dict[str, int]:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        counts: Dict[str, int] = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            counts["unembed"] = self.vocab_size * d
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        ffn_dense = 3 * d * self.d_ff  # SwiGLU
        dff_e = self.d_ff_expert or self.d_ff
        ffn_expert = 3 * d * dff_e
        per_kind = {
            "attn": attn + ffn_dense,
            "moe": attn
            + self.num_experts * ffn_expert
            + self.num_shared_experts * ffn_expert
            + d * self.num_experts,  # router
            "rec": (
                d * self.lru_width * 2  # in/gate proj
                + self.lru_width * self.conv1d_width
                + 2 * self.lru_width  # RG-LRU gates (diagonal)
                + self.lru_width * d  # out proj
                + ffn_dense
            ),
            "local": attn + ffn_dense,
            "ssm": (
                d * (2 * self.ssm_expand * d)  # x/z proj
                + self.ssm_expand * d * self.conv1d_width
                + self.ssm_expand * d * 2 * self.ssm_state  # B, C proj (approx)
                + self.ssm_expand * d  # dt
                + self.ssm_expand * d * d  # out proj
            ),
        }
        total_layers = 0
        for kind in self.layer_kinds:
            total_layers += per_kind[kind]
        counts["layers"] = total_layers
        counts["norms"] = (self.num_layers * 2 + 1) * d
        if self.frontend:
            counts["frontend_proj"] = self.frontend_dim * d
        return counts

    def num_params(self) -> int:
        return sum(self.param_counts().values())

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if not self.is_moe:
            return self.num_params()
        d = self.d_model
        dff_e = self.d_ff_expert or self.d_ff
        ffn_expert = 3 * d * dff_e
        n_moe_layers = sum(1 for k in self.layer_kinds if k == "moe")
        inactive = n_moe_layers * (
            (self.num_experts - self.top_k) * ffn_expert
        )
        return self.num_params() - inactive


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(full: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[full.name] = full
    _SMOKE[full.name] = smoke
    return full


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _SMOKE:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[name]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def shrink(
    cfg: ModelConfig,
    *,
    num_layers: int = 2,
    d_model: int = 64,
    num_heads: int = 4,
    num_kv_heads: Optional[int] = None,
    d_ff: int = 128,
    vocab_size: int = 256,
    num_experts: Optional[int] = None,
    **extra,
) -> ModelConfig:
    """Derive a reduced smoke config preserving the family-defining structure."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv_heads if num_kv_heads is not None else min(cfg.num_kv_heads, num_heads),
        d_ff=d_ff,
        vocab_size=vocab_size,
        head_dim=0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    if cfg.is_moe:
        kw["num_experts"] = num_experts if num_experts is not None else 8
        kw["top_k"] = min(cfg.top_k, kw["num_experts"])
        kw["d_ff_expert"] = d_ff
        # no-drop capacity in smoke configs so decode == forward exactly;
        # capacity-drop semantics are property-tested separately
        kw["capacity_factor"] = 8.0
    if cfg.lru_width:
        kw["lru_width"] = d_model
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 16
    if cfg.frontend:
        kw["frontend_dim"] = 32
        kw["frontend_tokens"] = 4
    if cfg.local_window:
        kw["local_window"] = 16
    kw.update(extra)
    return replace(cfg, **kw)
