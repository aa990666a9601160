"""PyTorch port, Mamba-2 (``ssm`` layers) on the paged plane: the SSD state
passes through the paged plane untouched (no layer has a pool; the page
table and prefix trie still bind each admission), as in the reference.

Gates: the smoke config served ``--paged`` gives the streams of the
unpaged replica and of the reference's replica (bridged weights), and the
CLI serves ``--paged`` but refuses ``--draft-tree`` (exit 2, the
reference's spec-width refusal).
"""
from __future__ import annotations

import dataclasses

import pytest

from _torch_arch_cases import reference_and_port_streams
from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve

ARCH = "mamba2-2.7b"


def test_paged_streams_equal_unpaged_and_reference(monkeypatch):
    kw = dict(decode_plane=True)
    jcfg, tcfg = dataclasses.replace(j_smoke(ARCH), **kw), dataclasses.replace(t_smoke(ARCH), **kw)
    want, unpaged, rep = reference_and_port_streams(jcfg, tcfg, 2, 24, 8, 4, monkeypatch)
    assert unpaged == want
    pcfg = dataclasses.replace(tcfg, paged=True, page_size=8)
    prep = tserve.ServeReplica(pcfg, 2, 24 + 8 + 1, rep.params, device="cpu")
    assert prep.pager is not None and all(set(c) == {"h", "conv"} for c in prep.cache)
    got = tserve.serve_queue(prep, tserve.synthetic_requests(pcfg.vocab_size, 24, 8, 4))
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert prep.admissions_paged == 4 and prep.launches > 0


def test_cli_serves_paged_and_refuses_a_draft_tree(capsys):
    code = tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--paged", "--page-size", "8", "--slots", "2",
                        "--prompt-len", "16", "--gen", "4", "--requests", "2", "--device", "cpu"])
    assert code == 0
    assert "paged: 2 admissions" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--paged", "--draft-tree", "2,1",
                     "--device", "cpu"])
    assert exc.value.code == 2
    assert "spec_tokens=1" in capsys.readouterr().err
