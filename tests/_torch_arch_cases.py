"""Helpers shared by the port's per-arch parity tests
(``test_torch_archs.py``, ``test_torch_llama4.py``, ``test_torch_frontend.py``,
``test_torch_rolling_paged.py``, ``test_torch_ssm_paged.py``): the weight
bridge, the reference's replica on an Auto-axis mesh with the ``check_rep``
shim (ROADMAP Queue C, R2/R3), the reference fabric's admission loop, and
one prefill-then-decode logits comparison of the two ``Model``s.
"""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint.manager import _flatten
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model as TModel

TOL = 1e-5


def bridge(jparams) -> dict:
    """The reference's params as its checkpoint leaves {name: array}."""
    names, leaves, _ = _flatten(jparams)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


def host_mesh():
    """A (1, 1) mesh with Auto axes (the reference's jax.make_mesh makes
    Explicit axes on this jax)."""
    from jax.sharding import AxisType

    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def patch_check_rep(monkeypatch) -> None:
    """The reference passes ``check_rep`` to ``shard_map``, which this jax
    renamed ``check_vma``."""
    import repro.parallel.moe_parallel as jmp

    if "check_rep" not in inspect.signature(jmp.shard_map).parameters:
        def shim(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return jax.shard_map(f, **kw)

        monkeypatch.setattr(jmp, "shard_map", shim)


def j_serve(rep, requests) -> dict:
    """The reference fabric's admission loop over one replica: {rid: tokens}."""
    queue, out = list(requests), {}
    while queue or rep.has_work():
        while queue and rep.free_slots():
            r = queue.pop(0)
            rep.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in rep.step():
            out[res.rid] = list(map(int, res.tokens))
    return out


def reference_and_port_streams(jcfg, tcfg, slots, prompt_len, gen, n_req, monkeypatch, *, tree=None,
                               drafter="ngram", seed=0):
    """Serve the CLI's synthetic queue on the reference's replica and on the
    port's (bridged weights); ``tree`` is the pair (reference TreePlan,
    port TreePlan) or None.  Returns (reference streams, port streams, port
    replica)."""
    from repro.launch.serve import ServeReplica as JReplica

    patch_check_rep(monkeypatch)
    T = max(tcfg.spec_tokens, 1)
    max_len = prompt_len + gen + T
    jp = JModel(jcfg).init(jax.random.PRNGKey(seed))
    reqs = tserve.synthetic_requests(tcfg.vocab_size, prompt_len, gen, n_req)
    jtree, ttree = tree if tree is not None else (None, None)
    jrep = JReplica(jcfg, host_mesh(), slots, max_len, jp, tree=jtree, drafter=drafter)
    want = j_serve(jrep, reqs)
    tp = params_from_numpy(tcfg, bridge(jp), "cpu")
    rep = tserve.ServeReplica(tcfg, slots, max_len, tp, tree=ttree, drafter=drafter, device="cpu")
    got = {rid: r.tokens for rid, r in tserve.serve_queue(rep, reqs).items()}
    return want, got, rep


def compare_logits(jcfg, tcfg, *, B=2, S=9, launches=3, Tn=2, frontend=False, seed=0):
    """Prefill B prompts of S tokens (with the reference's zero frontend
    input when ``frontend``), then ``launches`` decode launches of Tn
    tokens (the last greedy token and Tn - 1 random drafts; one accepted a
    launch), on both packages; logits within :data:`TOL` at every step and
    greedy ids equal.  Returns the port's prefill logits."""
    jcfg = dataclasses.replace(jcfg, spec_tokens=Tn)
    tcfg = dataclasses.replace(tcfg, spec_tokens=Tn)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, bridge(jp), "cpu")
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    max_len = S + launches + Tn
    jc = jm.init_cache(B, max_len)
    tc = tm.init_cache(B, max_len)
    if frontend:
        fe = np.zeros((B, jcfg.frontend_tokens, jcfg.frontend_dim), np.float32)
        jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc, jnp.asarray(fe, jnp.bfloat16))
        tl = tm.prefill(tp, prompts, tc, frontend=tm.frontend_stub(B))
    else:
        jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
        tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL, err_msg="prefill")
    jdec = jax.jit(jm.decode_tokens)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    lengths = np.full((B,), S, np.int32)
    prev = np.zeros((B,), np.int32)
    for step in range(launches):
        toks = rng.integers(0, jcfg.vocab_size, (B, Tn)).astype(np.int32)
        toks[:, 0] = last
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, prev)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"launch {step}")
        y = np.asarray(jnp.argmax(jlg, -1))
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"launch {step}")
        last = y[:, 0].astype(np.int32)
        lengths += 1
    return tl
