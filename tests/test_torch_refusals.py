"""PyTorch port, what the serve and train layers still refuse: the elastic
re-shard rebuild (``make_replica_factory(shrink_to=...)``) and fabric
checkpoints at ``--model > 1`` both name the distribution slice that brings
them (the cross-process fabric they used to wait for has shipped); the
train CLI refuses ``--data`` / ``--model`` > 1 without a launcher (a mesh
runs one rank per process under torchrun).  CPU only.
"""
from __future__ import annotations

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, train

ARCH = "qwen3-moe-235b-a22b"


def test_elastic_rebuild_refusal_names_the_distribution_slice():
    with pytest.raises(NotImplementedError) as err:
        serve.make_replica_factory(get_smoke_config(ARCH), 2, 32, None, [(None, 1)], shrink_to=(1, 1))
    msg = str(err.value)
    assert "distribution slice" in msg and "shrink_to" in msg
    assert "cross-process fabric" not in msg


def test_cli_refuses_fabric_checkpoints_of_an_expert_slice_naming_the_distribution_slice(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")  # as torchrun would set it for --model 2
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--device", "cpu", "--model", "2",
                    "--checkpoint-every", "2"])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "sharded fabric save in the distribution slice" in err
    assert "cross-process fabric" not in err


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_train_cli_refuses_more_than_one_rank(capsys, tmp_path, flag):
    with pytest.raises(SystemExit) as exit_:
        train.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu", flag, "2", "--ckpt", str(tmp_path)])
    assert exit_.value.code == 2
    assert "launch it with torchrun --nproc-per-node 2" in capsys.readouterr().err
