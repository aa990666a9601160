"""PyTorch port, the vision and audio frontend stubs (Phi-3-Vision-4.2B,
MusicGen-Large): ``params["frontend"]["proj"]`` projects the frontend input
onto the prompt's first F positions, as the reference's ``Model._embed``
does.

Gates, against the reference on the CPU with its weights bridged:

* prefill logits within 1e-5 (f32) with a random frontend input, for
  prompts of S = F and S > F;
* the served streams (admission passes the reference's zero frontend input
  (1, F, frontend_dim)) identical to the reference replica's, at spec
  widths 1 and 3;
* a prompt shorter than F is refused with ``RequestRejected`` before any
  launch (the reference's prefill crashes there: ROADMAP Queue C, R7), and
  ``Model.prefill`` raises ``ValueError``;
* the ``frontend/proj`` leaf is drawn with the reference's shape and
  round-trips through the port's ``CheckpointManager`` and the reference's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_cases import TOL, bridge, reference_and_port_streams
from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.checkpoint import CheckpointManager, params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model as TModel
from repro_torch.runtime.faults import RequestRejected

ARCHS = ("phi-3-vision-4.2b", "musicgen-large")


def _cfgs(arch, **kw):
    kw = dict(decode_plane=True, **kw)
    return dataclasses.replace(j_smoke(arch), **kw), dataclasses.replace(t_smoke(arch), **kw)


@pytest.mark.parametrize("S", [4, 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_with_a_frontend_input_match_reference(arch, S):
    jcfg, tcfg = _cfgs(arch)
    F, fd = tcfg.frontend_tokens, tcfg.frontend_dim
    assert S >= F == 4
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, bridge(jp), "cpu")
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    fe = rng.standard_normal((2, F, fd)).astype(np.float32)
    jl, _ = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jm.init_cache(2, S + 4), jnp.asarray(fe))
    tl = tm.prefill(tp, prompts, tm.init_cache(2, S + 4), frontend=torch.from_numpy(fe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    # the frontend input reaches the logits: the stub's zeros give others
    tz = tm.prefill(tp, prompts, tm.init_cache(2, S + 4), frontend=tm.frontend_stub(2))
    assert not torch.allclose(tz, tl)


@pytest.mark.parametrize("Tn", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_reference_replica(arch, Tn, monkeypatch):
    jcfg, tcfg = _cfgs(arch, spec_tokens=Tn)
    want, got, rep = reference_and_port_streams(jcfg, tcfg, 2, 8, 5, 4, monkeypatch)
    assert got == want and len(got) == 4 and all(len(t) == 6 for t in got.values())
    assert rep.prefills == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_shorter_than_the_frontend_is_refused(arch):
    _, tcfg = _cfgs(arch)
    tm = TModel(tcfg, device="cpu")
    params = tm.init(0)
    rep = tserve.ServeReplica(tcfg, 1, 16, params, device="cpu")
    short = tserve.Request(rid=5, prompt=np.arange(3, dtype=np.int32), gen=2)
    with pytest.raises(RequestRejected, match="frontend"):
        rep.admit(short)
    assert rep.prefills == 0 and not rep.has_work()
    res = tserve.serve_queue(rep, [short, tserve.Request(rid=6, prompt=np.arange(4, dtype=np.int32), gen=2)])
    assert res[5].error is not None and res[5].tokens == [] and len(res[6].tokens) == 3
    with pytest.raises(ValueError, match="shorter than the 4 frontend"):
        tm.prefill(params, np.zeros((1, 3), np.int32), tm.init_cache(1, 8), frontend=tm.frontend_stub(1))


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_leaf_round_trips_through_checkpoints(arch, tmp_path):
    from repro.checkpoint import CheckpointManager as JManager

    jcfg, tcfg = _cfgs(arch)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    assert jp["frontend"]["proj"].shape == (tcfg.frontend_dim, tcfg.d_model)
    tp = TModel(tcfg, device="cpu").init(0)
    assert tuple(tp["frontend"]["proj"].shape) == (tcfg.frontend_dim, tcfg.d_model)
    # the port's save, read back by the port and by the reference
    CheckpointManager(tmp_path / "port", cfg=tcfg).save(1, tp, {})
    back = CheckpointManager(tmp_path / "port", cfg=tcfg).restore("cpu")[0]
    assert torch.equal(back["frontend"]["proj"], tp["frontend"]["proj"])
    jback = JManager(tmp_path / "port").restore(jp, {})[0]
    np.testing.assert_array_equal(np.asarray(jback["frontend"]["proj"]), tp["frontend"]["proj"].numpy())
    # the reference's save, read by the port
    JManager(tmp_path / "ref").save(1, jp, {})
    tback = CheckpointManager(tmp_path / "ref", cfg=tcfg).restore("cpu")[0]
    np.testing.assert_array_equal(tback["frontend"]["proj"].numpy(), np.asarray(jp["frontend"]["proj"]))
