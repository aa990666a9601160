"""PyTorch port, what the train layer still refuses: the train CLI refuses
``--data`` / ``--model`` > 1 without a launcher (a mesh runs one rank per
process under torchrun).  CPU only.
"""
from __future__ import annotations

import pytest

from repro_torch.launch import train


@pytest.mark.parametrize("flag", ["--data", "--model"])
def test_train_cli_refuses_more_than_one_rank(capsys, tmp_path, flag):
    with pytest.raises(SystemExit) as exit_:
        train.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu", flag, "2", "--ckpt", str(tmp_path)])
    assert exit_.value.code == 2
    assert "launch it with torchrun --nproc-per-node 2" in capsys.readouterr().err
