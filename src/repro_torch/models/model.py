"""Model facade (port of ``repro/models/model.py``): init, cache, prefill,
speculative chain and tree decode, and the cache surgery of continuous
batching (contiguous, paged and rolling) for the ``moe``/``attn``/``local``/``rec``/``ssm``
decoder stack, with the vision / audio frontend stub; and the training
forward (:meth:`Model.forward_train`, the next-token loss) of ``attn``,
``local``, ``moe`` and ``rec`` stacks over f32 master weights
(``init(train=True)``).

The cache is updated in place by :meth:`Model.prefill`,
:meth:`Model.decode_tokens` and the surgery methods; the first two return
only logits (and, with telemetry, a metrics dict).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plans import TreePlan
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import Params


class Model:
    """``device=None`` means the card; pass ``device="cpu"`` for the plain
    PyTorch path (every kernel wrapper then runs its plain version).

    ``moe_apply`` and ``decode_moe_apply`` replace the MoE layers' prefill
    data plane and decode-plane plan executor (the distributed runtime binds
    the expert-parallel ones, :func:`repro_torch.launch.steps.build_model`);
    the defaults are the single-host :func:`transformer.default_moe_apply`
    and :func:`repro_torch.models.moe.moe_decode_ffn`.  ``experts`` is the
    slice of every expert stack that :meth:`init` keeps (a rank's share).

    Training on a mesh (:func:`repro_torch.launch.steps.build_model` with
    ``train=True``) binds two more: ``train_moe_apply`` ``(x_ffn,
    route_src, p) -> (y, aux (2,))``, the MoE layers' differentiable
    expert-parallel apply (default: :func:`repro_torch.models.moe.moe_layer`
    on the layer's whole stacks), and ``gather(path, tree) -> tree``, which
    makes a rank's shards of the leaves under ``path`` (``()`` for the
    leaves outside ``layers``, ``("layers", i)`` for a layer) whole just
    before they are used, under autograd: once a forward for the former,
    once a layer call for the latter (again in the backward under remat)."""

    def __init__(self, cfg: ModelConfig, device=None, moe_apply: Optional[T.MoeApply] = None,
                 decode_moe_apply: Optional[T.DecodeApply] = None, experts: Optional[slice] = None,
                 train_moe_apply=None, gather=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.moe_apply = moe_apply or T.default_moe_apply(cfg)
        self.decode_moe_apply = decode_moe_apply or moe.moe_decode_ffn
        self.experts = experts
        self.train_moe_apply = train_moe_apply
        self.gather = gather

    def _use(self, path, tree):
        return tree if self.gather is None else self.gather(path, tree)

    # ------------------------------------------------------------------
    def init(self, seed: Union[int, torch.Generator] = 0, *, train: bool = False) -> Params:
        """Random weights drawn on the model's device from a seeded generator
        (of the expert stacks, the model's ``experts`` slice).  ``train``
        keeps every leaf in ``cfg.param_dtype`` (f32 master weights, cast to
        ``cfg.dtype`` where each is used, as the reference trains)."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return T.init_params(self.cfg, gen, self.device, self.experts, train=train)

    def init_cache(self, batch: int, max_len: int, pool_batch: Optional[int] = None) -> List[Params]:
        return T.init_cache(self.cfg, batch, max_len, self.device, pool_batch)

    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor, frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings scaled by sqrt(d_model); with a frontend config
        and ``frontend`` (B, F, frontend_dim) the first F positions are
        ``frontend @ params["frontend"]["proj"]`` instead (the reference's
        vision / audio stub)."""
        dtype = L.act_dtype(self.cfg)
        x = L.embed(tokens, params["embed"], dtype)
        if self.cfg.frontend and frontend is not None:
            F = frontend.shape[1]
            fx = torch.einsum("bfe,ed->bfd", frontend.to(dtype), params["frontend"]["proj"].to(dtype))
            x = torch.cat([fx, x[:, F:]], dim=1)
        return x * torch.sqrt(torch.tensor(float(self.cfg.d_model), dtype=torch.float32)).to(dtype)

    def frontend_stub(self, batch: int = 1) -> Optional[torch.Tensor]:
        """The frontend input admission passes, as the reference's replica
        does: zeros (batch, frontend_tokens, frontend_dim) in bf16 on the
        model's device, or None without a frontend."""
        if not self.cfg.frontend:
            return None
        return torch.zeros((batch, self.cfg.frontend_tokens, self.cfg.frontend_dim), dtype=torch.bfloat16,
                           device=self.device)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """f32 logits against ``params["unembed"]``: the untied table, or the
        f32 copy of the tied embedding (:func:`transformer.place_tied_unembed`);
        training params of a tied model have no copy and read ``embed``."""
        x = L.rms_norm(x, params["final_norm"])
        return L.unembed(x, params["unembed"] if "unembed" in params else params["embed"])

    # ------------------------------------------------------------------
    # train forward
    # ------------------------------------------------------------------
    def stack_train(self, params: Params, x: torch.Tensor, positions: torch.Tensor):
        """The layers, training-style (:func:`transformer.apply_layer_train`);
        returns ``(x, aux (2,))``.  Under ``cfg.remat`` each whole super-block
        (one cycle of ``cfg.block_pattern``) runs inside
        ``torch.utils.checkpoint.checkpoint`` (its activations are recomputed
        in the backward, as the reference's ``jax.checkpoint(sb_fn)``); a
        pattern-incomplete tail is not rematerialized, as in the reference."""
        cfg = self.cfg
        pat = cfg.block_pattern
        n_sb = cfg.num_layers // len(pat)
        layers = params["layers"]
        route_src = x  # layer-0 control-plane source = embeddings

        def layer(i, h, rs, kind):
            return T.apply_layer_train(h, rs, self._use(("layers", i), layers[i]), kind, cfg, positions,
                                       moe_apply=self.train_moe_apply)

        def sb_fn(h, rs, s):
            aux = torch.zeros((2,), dtype=torch.float32, device=h.device)
            for j, kind in enumerate(pat):
                h, rs, a = layer(s * len(pat) + j, h, rs, kind)
                aux = aux + a
            return h, rs, aux

        aux_total = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for s in range(n_sb):
            if cfg.remat:
                x, route_src, a = torch.utils.checkpoint.checkpoint(sb_fn, x, route_src, s, use_reentrant=False)
            else:
                x, route_src, a = sb_fn(x, route_src, s)
            aux_total = aux_total + a
        kinds = cfg.layer_kinds
        for i in range(n_sb * len(pat), cfg.num_layers):
            x, route_src, a = layer(i, x, route_src, kinds[i])
            aux_total = aux_total + a
        return x, aux_total

    def forward_train(self, params: Params, tokens: torch.Tensor, frontend: Optional[torch.Tensor] = None, *,
                      lb_coef: float = 0.01, z_coef: float = 1e-4):
        """Next-token cross-entropy over the backbone (f32 logits), frontend
        positions masked; ``(loss, {"loss", "ce", "lb_loss", "z_loss"})``,
        each a 0-d f32 tensor, as the reference's."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        B, S = tokens.shape
        if self.gather is not None:  # the leaves outside the layers, whole, once a forward
            params = dict(self._use((), {k: v for k, v in params.items() if k != "layers"}), layers=params["layers"])
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = self._embed(params, tokens, None if frontend is None else frontend.to(self.device))
        x, aux = self.stack_train(params, x, positions)
        logits = self.logits(params, x)  # (B, S, V) f32
        lg = logits[:, :-1]
        nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, tokens[:, 1:, None])[..., 0]  # (B, S-1)
        F = cfg.frontend_tokens if cfg.frontend else 0
        mask = (torch.arange(S - 1, device=self.device) >= F).to(torch.float32)[None, :]
        denom = torch.clamp(mask.sum() * B, min=1.0)
        ce = (nll * mask).sum() / denom
        n_moe = max(sum(1 for k in cfg.layer_kinds if k == "moe"), 1)
        loss = ce + lb_coef * aux[0] / n_moe + z_coef * aux[1] / n_moe
        return loss, {"loss": loss, "ce": ce, "lb_loss": aux[0] / n_moe, "z_loss": aux[1] / n_moe}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params: Params, tokens, cache: List[Params], slot: int = 0,
                frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run the (B, S) prompt(s) and write their K/V and seeded plans into
        batch rows ``[slot, slot + B)`` of ``cache`` in place (admission
        writes a B=1 prefill straight into its slot); returns the
        last-position logits (B, V).  ``frontend`` (B, F, frontend_dim)
        replaces the first F positions' embeddings (:meth:`_embed`); a
        prompt shorter than F raises ``ValueError`` (the reference's
        concatenation would make F rows of it)."""
        tokens = self._tokens(tokens)
        B, S = tokens.shape
        if self.cfg.frontend and frontend is not None and S < frontend.shape[1]:
            raise ValueError(f"a prompt of {S} tokens is shorter than the {frontend.shape[1]} frontend positions")
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = self._embed(params, tokens, None if frontend is None else frontend.to(self.device))
        route_src = x  # layer-0 control-plane source = embeddings
        rows = slice(slot, slot + B)
        for kind, p, c in zip(self.cfg.layer_kinds, params["layers"], cache):
            x, route_src = T.apply_layer_prefill(x, route_src, p, c, kind, self.cfg, positions, rows,
                                                 self.moe_apply)
        return self.logits(params, x[:, -1:, :])[:, 0]

    @torch.no_grad()
    def decode_tokens(
        self,
        params: Params,
        cache: List[Params],
        tokens,                 # (B, T): last accepted token + T-1 drafts (or tree nodes)
        lengths,                # (B,) per-sequence tokens already in the cache
        prev_accept=None,       # (B,) plan-row select
        *,
        telemetry: bool = False,
        tree: Optional[TreePlan] = None,
        pages=None,             # (B, max_pages) int32 block tables (paged caches)
        commit: Optional[Tuple] = None,  # (dst, src) (B, Tc) logical row moves, -1 = none
        max_len: Optional[int] = None,   # row capacity when no layer holds a full-length cache
    ):
        """One speculative launch over a ragged batch: token (b, t) sits at
        position ``lengths[b] + t``; returns logits (B, T, V) that score each
        position's successor.  ``prev_accept`` selects the cached plan row
        routed from the position the previous launch's verification accepted
        last (rollback-exact plan carry).

        With ``tree`` (``num_nodes == T``) the tokens form a draft tree:
        node t rides cache row ``lengths[b] + t`` at rotary position
        ``lengths[b] + depth(t)`` and attends through the tree's ancestor
        mask; ``prev_accept`` is then the accepted node index.  ``tree=None``
        is the chain ``TreePlan.chain(T)``, served by the same path.  Paged caches
        take ``pages``, the block table steering every K/V access, and
        ``commit``, the previous verify round's accepted-path row moves in
        logical positions, applied at the top of each layer before its
        writes (the tree commit fused into the launch).  The block table and
        the commit maps cross to the device once per launch.

        Positions are checked against the row capacity of the first
        full-attention layer (its stripe, or its block table); rolling
        buffers and ``rec``/``ssm`` state bound no position, so a stack
        without a full-attention layer (RecurrentGemma, a pure-SSM Mamba-2)
        is checked against ``max_len`` when given.

        With ``telemetry`` returns ``(logits, {"plan_agreement": float})``:
        the mean stale-vs-fresh plan top-k agreement over the MoE layers
        (one device read per launch).

        The launch is :meth:`decode_inputs` (the host checks) and then
        :meth:`decode_body` (the device work) on the inputs copied to the
        model's device."""
        tokens, lengths, prev, tree, pages, commit = self.decode_inputs(
            cache, tokens, lengths, prev_accept, tree=tree, pages=pages, commit=commit, max_len=max_len)
        dev = self.device
        logits, agreement = self.decode_body(
            params, cache, torch.as_tensor(tokens, device=dev), torch.as_tensor(lengths, device=dev),
            torch.as_tensor(prev, device=dev), tree=tree,
            pages=None if pages is None else torch.as_tensor(pages, device=dev),
            commit=None if commit is None else tuple(torch.as_tensor(m, device=dev) for m in commit),
            telemetry=telemetry)
        if telemetry:
            return logits, {"plan_agreement": self.plan_agreement(agreement)}
        return logits

    def decode_inputs(self, cache: List[Params], tokens, lengths, prev_accept=None, *,
                      tree: Optional[TreePlan] = None, pages=None, commit: Optional[Tuple] = None,
                      max_len: Optional[int] = None):
        """The host half of :meth:`decode_tokens`: its checks, raising its
        ``ValueError``s, and its inputs as host arrays ``(tokens (B, T)
        int64, lengths (B,) int64, prev_accept (B,) int64, tree, pages
        (B, max_pages) int32 or None, commit (dst, src) int64 or None)``,
        ``tree`` the chain when None was given.  Reads nothing on the
        device."""
        tokens = np.asarray(tokens, np.int64)
        B, Tn = tokens.shape
        tree = TreePlan.chain(Tn) if tree is None else tree
        if tree.num_nodes != Tn:
            raise ValueError(f"tree has {tree.num_nodes} nodes but the launch carries {Tn} tokens")
        lengths = np.asarray(lengths, np.int64).reshape(B)
        full = [c for kind, c in zip(self.cfg.layer_kinds, cache)
                if kind not in T.STATE_KINDS and not T.window_of(self.cfg, kind)]
        paged = bool(full) and "pk" in full[0]
        if paged and pages is None:
            raise ValueError("paged cache without a block table: pass pages=(B, max_pages) int32 "
                             "(see models.transformer.identity_page_table)")
        if paged:
            pages = np.asarray(pages, np.int32)
            max_len = pages.shape[1] * self.cfg.page_size
        elif full:
            max_len = full[0]["k"].shape[1]
        if lengths.min() < 0 or (max_len is not None and lengths.max() + Tn > max_len):
            raise ValueError(f"positions up to {lengths.max() + Tn - 1} fall outside the cache of {max_len} rows")
        prev = np.zeros((B,), np.int64) if prev_accept is None else np.asarray(prev_accept, np.int64).reshape(B)
        if prev.min() < 0 or prev.max() >= max(self.cfg.spec_tokens, 1):
            raise ValueError(f"prev_accept {prev.tolist()} selects no row of a {self.cfg.spec_tokens}-row plan vector")
        if commit is not None:
            commit = tuple(np.asarray(m, np.int64) for m in commit)
        return tokens, lengths, prev, tree, (pages if paged else None), commit

    @torch.no_grad()
    def decode_body(self, params: Params, cache: List[Params], tokens: torch.Tensor, lengths: torch.Tensor,
                    prev_accept: torch.Tensor, *, tree: TreePlan, pages: Optional[torch.Tensor] = None,
                    commit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, telemetry: bool = False):
        """The device half of :meth:`decode_tokens`: every input already on
        the model's device (tokens (B, T), lengths and prev_accept (B,)
        int64, pages (B, max_pages) int32, commit maps (B, Tc) int64), no
        check and no read back to the host, so a CUDA graph can capture it
        (:mod:`repro_torch.launch.steps`).  Returns ``(logits (B, T, V),
        agreement)``: with ``telemetry`` the 0-d sum of the MoE layers'
        plan agreements (:meth:`plan_agreement` makes it the mean), else
        None."""
        x = self._embed(params, tokens)
        route_src = x
        agree = []
        for kind, p, c in zip(self.cfg.layer_kinds, params["layers"], cache):
            x, route_src, a = T.apply_layer_decode_spec(
                x, route_src, p, c, kind, self.cfg, lengths, prev_accept,
                telemetry=telemetry, tree=tree, pages=pages, commit=commit,
                moe_apply=self.moe_apply, decode_apply=self.decode_moe_apply,
            )
            if a is not None:
                agree.append(a)
        return self.logits(params, x), (torch.stack(agree).sum() if agree else None)

    def plan_agreement(self, total) -> float:
        """The mean plan agreement from :meth:`decode_body`'s sum (0.0 when
        no layer reported one): one read of a 0-d tensor."""
        if total is None:
            return 0.0
        return float(total) / sum(kind == "moe" for kind in self.cfg.layer_kinds)

    # ------------------------------------------------------------------
    # continuous-batching cache surgery (in place)
    # ------------------------------------------------------------------
    @staticmethod
    def write_cache_slot(cache: List[Params], one_cache: List[Params], slot: int) -> None:
        """Copy a B=1 cache (every leaf: K/V, plan rows, ``rec``/``ssm`` state)
        into batch row ``slot``, in place."""
        for c, o in zip(cache, one_cache):
            for name, leaf in c.items():
                leaf[slot].copy_(o[name][0])

    @staticmethod
    def copy_cache_slot(cache: List[Params], src: int, dst: int) -> None:
        """Copy batch row ``src`` of every leaf of a contiguous cache into
        row ``dst``, in place (a fork's branches off one prefill)."""
        for c in cache:
            for leaf in c.values():
                leaf[dst].copy_(leaf[src])

    @staticmethod
    def write_cache_slot_paged(cache: List[Params], one_cache: List[Params], slot: Optional[int], rows) -> None:
        """Paged admission, in place: scatter a CONTIGUOUS B=1 cache's K/V
        rows into the pool rows that ``rows`` names, never a stripe copy.

        ``rows`` is the (max_len,) vector of physical pool rows backing each
        logical position; entries at or past the pool size (the
        admission's sentinel) land in the trash row, which is how
        trie-shared pages and positions past the prompt skip the copy.
        Shared pages are never written and the pool is never zeroed.  An
        int8 pool's scale rows (``pks``/``pvs``, from the prefill's
        ``ks``/``vs``) go through the same row scatter, trash row included.
        The DecodePlan leaves, rolling buffers (unpaged under
        ``cfg.paged``) and ``rec``/``ssm`` state are per slot and are
        written at batch ``slot`` (not at all when ``slot`` is None).  The
        row vector crosses to the device once for all layers."""
        pools = [c["pk"] for c in cache if "pk" in c]
        if pools:
            R = pools[0].shape[0] - 1
            idx = torch.as_tensor(np.asarray(rows, np.int64), device=pools[0].device).clamp(max=R)
        for c, o in zip(cache, one_cache):
            for name, leaf in c.items():
                if name in T.POOL_LEAVES:
                    src = o[name[1:]][0]
                    leaf[idx[: src.shape[0]]] = src.to(leaf.dtype)
                elif slot is not None:
                    leaf[slot].copy_(o[name][0])

    def paginate_cache(self, cache: List[Params], max_len: int) -> List[Params]:
        """A NEW paged cache holding ``cache``'s contents in the pool layout:
        with the identity block table (:func:`transformer.identity_page_table`)
        slot ``b``'s position ``pos`` lands at pool row
        ``b * max_pages * page_size + pos``, the flattened contiguous buffer,
        so the paged chain path is bitwise the contiguous path on it.  An
        int8 cache's scale rows flatten the same way into ``pks``/``pvs``,
        padded with ONES (their initial value) where the payload is padded
        with zeros.  Plan leaves, rolling buffers and ``rec``/``ssm`` state
        are copied unchanged (they stay unpaged)."""
        ps, mp = self.cfg.page_size, T.max_pages_for(self.cfg, max_len)
        out = []
        for kind, c in zip(self.cfg.layer_kinds, cache):
            if kind not in T.STATE_KINDS and T.window_of(self.cfg, kind):
                out.append({name: leaf.clone() for name, leaf in c.items()})
                continue
            n = {}
            for name, leaf in c.items():
                if name in ("k", "v"):
                    B, S, nkv, hd = leaf.shape
                    pool = leaf.new_zeros((B * mp * ps + 1, nkv, hd))
                    pool[:-1].view(B, mp * ps, nkv, hd)[:, :S] = leaf
                    n["p" + name] = pool
                elif name in ("ks", "vs"):
                    B, S = leaf.shape
                    pool = leaf.new_ones((B * mp * ps + 1,))
                    pool[:-1].view(B, mp * ps)[:, :S] = leaf
                    n["p" + name] = pool
                else:
                    n[name] = leaf.clone()
            out.append(n)
        return out

    @staticmethod
    def commit_tree_path(cache: List[Params], lengths, path) -> None:
        """Compact an accepted draft-tree root path into contiguous cache
        rows, in place (contiguous caches; paged ones commit through the
        fused maps of :func:`repro_torch.core.pages.commit_maps`).

        The accepted nodes ``path[b] = (0, u_1, ..., u_{a-1})`` sit at rows
        ``lengths[b] + u_i`` and must move to ``lengths[b] + i``; ``path`` is
        (B, T), padded with the identity so the pad writes copy rows onto
        themselves.  Only K/V (with an int8 cache's scale rows) move: plan
        rows stay node-indexed.  The gather lands in a temporary before the
        scatter."""
        dev = cache[0]["k"].device
        Model.commit_rows(cache, torch.as_tensor(np.asarray(lengths, np.int64), device=dev),
                          torch.as_tensor(np.asarray(path, np.int64), device=dev))

    @staticmethod
    def commit_rows(cache: List[Params], lengths: torch.Tensor, path: torch.Tensor) -> None:
        """The device half of :meth:`commit_tree_path`: lengths (B,) and
        path (B, T) int64 already on the cache's device, nothing read back,
        so a CUDA graph can capture it."""
        k0 = cache[0]["k"]
        dev = k0.device
        Tn = path.shape[1]
        dst = lengths[:, None] + torch.arange(Tn, device=dev)[None, :]
        src = lengths[:, None] + path
        bidx = torch.arange(k0.shape[0], device=dev)[:, None]
        for c in cache:
            for name in T.KV_LEAVES:
                if name in c:
                    moved = c[name][bidx, src]
                    c[name][bidx, dst] = moved
