"""PyTorch port, kernel 7's build choice, on the CPU: which build
(``flash_attention_path``) a launch takes at every dtype and head dim, and
the wrapper's refusal of a head dim no build has before anything is built
or launched (on the card nothing falls back to another build or to the
plain version).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_path_at_every_dtype_and_head_dim(dtype, hd):
    """bf16 at 64, 96, 128, 160 and 256 (every registered arch's prefill)
    takes the tensor cores; f32 at every head dim and bf16 at 16 and 32
    take the CUDA-core build."""
    tc = dtype == torch.bfloat16 and hd in (64, 96, 128, 160, 256)
    assert fa_ops.flash_attention_path(dtype, hd) == ("tensor_cores" if tc else "cuda_cores")
    assert fa_ops._HEAD_DIMS == HEAD_DIMS


@pytest.mark.parametrize("hd", [8, 48, 80, 112, 192, 320])
def test_head_dims_outside_the_builds_are_refused(hd, monkeypatch):
    """The path names no build, and the launch raises before any library
    is built or loaded; the CPU wrapper still runs the plain version."""
    def no_library(*args):
        raise AssertionError("a library was asked for")

    monkeypatch.setattr(fa_ops, "function", no_library)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
            fa_ops.flash_attention_path(dtype, hd)
        q = torch.zeros((1, 5, 2, hd), dtype=dtype)
        k = torch.zeros((1, 5, 1, hd), dtype=dtype)
        with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
            fa_ops._launch_prefill(q, k, k, True, 0)
        assert torch.equal(fa_ops.flash_attention_kernel(q, k, k, causal=True),
                           fa_ref.flash_attention(q, k, k, causal=True))
