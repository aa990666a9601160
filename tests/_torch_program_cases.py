"""Helpers shared by the request-program tests of the PyTorch port
(``test_torch_programs.py``, ``test_torch_forks.py``): the reference's
weights bridged into the port, the reference's masked sequential oracle,
reference replicas on an Auto-axis mesh, and a drain loop that admits forks
when enough slots are free."""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.programs import compile_program as j_compile, masked_argmax as j_masked_argmax
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.programs import program_slots
from repro_torch.runtime.fabric import Request

MOE = "qwen3-moe-235b-a22b"
GEN = 10
WIDTH = 3
SCHEMA = {"type": "object", "properties": {"a": {"type": "integer", "maxDigits": 2}}}
SPEC = {"segments": [{"kind": "json_schema", "schema": SCHEMA}]}
MAX_LEN = 9 + GEN + WIDTH


def configs(arch=MOE, **fields):
    """(reference cfg, port cfg) of the smoke config with ``fields``."""
    return (dataclasses.replace(j_smoke(arch), **fields), dataclasses.replace(t_smoke(arch), **fields))


def bridged(cfg_j, cfg_t, key=0):
    """(reference params from PRNGKey(key), the same weights in the port on the CPU)."""
    params = JModel(cfg_j).init(jax.random.PRNGKey(key))
    names, leaves, _ = _flatten(params)
    return params, params_from_numpy(cfg_t, {n: np.asarray(v) for n, v in zip(names, leaves)}, "cpu")


def requests(vocab, spec, n=3, gen=GEN, sizes=(6, 9)):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=sizes[i % len(sizes)]).astype(np.int32), gen=gen,
                    program=spec) for i in range(n)]


def masked_oracle(cfg_j, params_j, reqs, spec, max_len, first_rank=0):
    """Per-request sequential greedy on the reference model (no mesh) with
    the same automaton mask at every step: what every constrained plane
    must reproduce.  ``first_rank`` forces the first token to the prefill's
    ``first_rank``-th best allowed token (a fork branch)."""
    c1 = dataclasses.replace(cfg_j, spec_tokens=1, paged=False)
    m1 = JModel(c1)
    pre1, dec1 = jax.jit(m1.prefill), jax.jit(m1.decode_step)
    auto = j_compile(spec, cfg_j.vocab_size).automaton
    neg = np.finfo(np.float32).min
    out = {}
    for req in reqs:
        lg, cache = pre1(params_j, jnp.asarray(req.prompt)[None], m1.init_cache(1, max_len))
        st = auto.start
        order = np.argsort(-np.where(auto.mask(st), np.asarray(lg[0], np.float32), neg), kind="stable")
        tok = int(order[first_rank])
        st = auto.step(st, tok)
        stream = [tok]
        for s in range(req.gen):
            if auto.is_accept(st):
                break
            lg, cache = dec1(params_j, cache, jnp.asarray([tok], jnp.int32), jnp.int32(len(req.prompt) + s))
            tok = j_masked_argmax(np.asarray(lg[0]), auto.mask(st))
            st = auto.step(st, tok)
            stream.append(tok)
        assert auto.walk(auto.start, stream) >= 0  # the oracle never emits a masked token
        out[req.rid] = stream
    return out


def host_mesh():
    """A (1, 1) mesh with Auto axes: the reference's sharding constraints
    name its axes, which jax.make_mesh now makes Explicit by default."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def shim_check_rep(monkeypatch):
    """The reference passes shard_map ``check_rep``, which this jax renamed
    ``check_vma``: map the keyword for the reference's MoE layers."""
    import repro.parallel.moe_parallel as moe_parallel

    if "check_rep" not in inspect.signature(moe_parallel.shard_map).parameters:
        def shard_map(f, **kw):
            if "check_rep" in kw:
                kw["check_vma"] = kw.pop("check_rep")
            return jax.shard_map(f, **kw)

        monkeypatch.setattr(moe_parallel, "shard_map", shard_map)


def j_request(req):
    return JRequest(rid=req.rid, prompt=req.prompt, gen=req.gen, program=req.program)


def drain(rep, reqs, convert=lambda r: r):
    """Admit from the front while the replica has the slots a request's
    program needs, step until everything is answered; {rid: Result}."""
    results = {}
    queue = list(reqs)
    for _ in range(500):
        while queue and len(rep.free_slots()) >= program_slots(getattr(queue[0], "program", None)):
            rep.admit(convert(queue.pop(0)))
        if not rep.has_work():
            if not queue:
                return results
            continue
        for res in rep.step():
            results[res.rid] = res
    raise AssertionError("replica did not drain")


def fork_counters(rep):
    return {n: int(getattr(rep, n)) for n in ("prefills", "forks_started", "forks_live_max", "fork_kv_rows_copied",
                                              "prog_tokens", "prog_mask_cnt", "prog_masked_emissions",
                                              "accepted_total", "drafted_total", "launches")}
