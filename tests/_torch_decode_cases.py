"""Cases and helpers shared by the compiled-launch tests of the PyTorch port
(``test_torch_compiled_launch.py`` on the CPU, ``test_torch_cuda_graphs.py``
on the card): the smoke configurations of every plane and family, an
admitted cache, and fresh host inputs per launch.  Imports no jax."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.plans import TreePlan
from repro_torch.models.model import Model
from repro_torch.models.transformer import max_pages_for

MOE = "qwen3-moe-235b-a22b"
VARIANT = dict(num_experts=16, top_k=2)  # plan rows that are not all the experts
B, PROMPT, MAX_LEN, LAUNCHES = 2, 12, 40, 4

# name -> (arch, config fields, tree branching or None, telemetry)
CASES = {
    "chain": (MOE, dict(spec_tokens=4, **VARIANT), None, True),
    "tree": (MOE, dict(spec_tokens=5, **VARIANT), (2, 2), False),
    "paged chain": (MOE, dict(spec_tokens=3, paged=True, page_size=8, **VARIANT), None, False),
    "paged tree": (MOE, dict(spec_tokens=4, paged=True, page_size=8, **VARIANT), (2, 1), True),
    "int8": (MOE, dict(spec_tokens=4, kv_dtype="int8", expert_dtype="int8", **VARIANT), None, False),
    "hybrid": ("recurrentgemma-2b", dict(spec_tokens=1), None, False),
    "ssm": ("mamba2-2.7b", dict(spec_tokens=1), None, False),
}


def case(name):
    """(cfg, tree or None, telemetry) of the case ``name``."""
    arch, fields, branching, telemetry = CASES[name]
    cfg = dataclasses.replace(get_smoke_config(arch), decode_plane=True, **fields)
    tree = TreePlan.from_branching(branching) if branching else None
    return cfg, tree, telemetry


def admitted(cfg, device, seed=0):
    """(model, params, cache) on ``device`` with a random prompt prefilled
    into each slot (paged: the contiguous cache laid into the pool)."""
    flat = Model(dataclasses.replace(cfg, paged=False), device=device)
    params = flat.init(seed)
    cache = flat.init_cache(B, MAX_LEN)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, PROMPT))
    for b in range(B):
        flat.prefill(params, prompts[b:b + 1], cache, slot=b)
    model = Model(cfg, device=device)
    if cfg.paged:
        cache = model.paginate_cache(cache, MAX_LEN)
    return model, params, cache


def clone(cache):
    return [{n: t.clone() for n, t in c.items()} for c in cache]


def inputs(cfg, tree, rng):
    """One launch's host inputs, drawn afresh: every control word changes."""
    Tn = tree.num_nodes if tree else max(cfg.spec_tokens, 1)
    kw = {}
    if cfg.paged:
        mp = max_pages_for(cfg, MAX_LEN)
        kw["pages"] = rng.permutation(B * mp).reshape(B, mp).astype(np.int32)
        if tree is not None and not tree.is_chain():
            kw["commit"] = (rng.integers(-1, MAX_LEN, (B, Tn)), rng.integers(0, MAX_LEN, (B, Tn)))
    return (rng.integers(0, cfg.vocab_size, (B, Tn)), rng.integers(3, MAX_LEN - Tn + 1, B),
            rng.integers(0, max(cfg.spec_tokens, 1), B), kw)


def root_paths(tree, rng):
    """(B, T) accepted root paths padded with the identity."""
    kids, Tn = tree.children(), tree.num_nodes
    out = np.tile(np.arange(Tn), (B, 1))
    for b in range(B):
        path, node = [0], 0
        while kids[node] and rng.random() < 0.7:
            node = kids[node][rng.integers(len(kids[node]))]
            path.append(node)
        out[b, :len(path)] = path
    return out
