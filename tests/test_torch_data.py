"""PyTorch port, data pipeline: the datasets give the reference's batches
for the same (seed, step), the loader places them (and the frontend stub's
features) on the device unchanged, and ``seek`` replays a step exactly.
CPU only."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.data import FileTokenDataset as JFile
from repro.data import MarkovLMDataset as JMarkov
from repro.data import ShardedLoader as JLoader
from repro_torch.data import FileTokenDataset, MarkovLMDataset, ShardedLoader
from _torch_arch_cases import host_mesh


@pytest.mark.parametrize("vocab,seq,seed,branching", [(64, 33, 0, 4), (49152, 128, 7, 4), (256, 16, 3, 2)])
def test_markov_batches_equal_the_reference(vocab, seq, seed, branching):
    ours, theirs = (cls(vocab, seq, seed=seed, branching=branching) for cls in (MarkovLMDataset, JMarkov))
    for step in (0, 1, 5, 1000):
        a, b = ours.batch(step, 4)["tokens"], theirs.batch(step, 4)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_token_batches_equal_the_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, size=5000).astype(dtype).tofile(path)
    ours, theirs = FileTokenDataset(path, 64, dtype=dtype, seed=2), JFile(path, 64, dtype=dtype, seed=2)
    assert ours.n_seqs == theirs.n_seqs == 78
    for step in (0, 3, 77):
        np.testing.assert_array_equal(ours.batch(step, 5)["tokens"], theirs.batch(step, 5)["tokens"])


def test_loader_places_the_reference_batches_and_seek_replays():
    """Steps 3..6 through both loaders (the reference's on an Auto-axis
    (1, 1) mesh) with the frontend stub; then ``seek(4)`` gives step 4's
    batch again, bit for bit."""
    ds = MarkovLMDataset(97, 24, seed=5)
    ours = ShardedLoader(ds, 3, "cpu", start_step=3, frontend_spec=(4, 6))
    theirs = JLoader(JMarkov(97, 24, seed=5), 3, host_mesh(), start_step=3, frontend_spec=(4, 6))
    try:
        seen = {}
        for want_step in range(3, 7):
            step, batch = next(ours)
            jstep, jbatch = next(theirs)
            assert step == jstep == want_step
            assert sorted(batch) == sorted(jbatch) == ["frontend", "tokens"]
            assert batch["tokens"].dtype == torch.int32 and batch["frontend"].dtype == torch.float32
            for k in batch:
                np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jax.device_get(jbatch[k])))
            seen[step] = {k: v.clone() for k, v in batch.items()}
        ours.seek(4)
        for want_step in (4, 5):
            step, batch = next(ours)
            assert step == want_step
            assert all(torch.equal(batch[k], seen[step][k]) for k in batch)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("steps_taken", [0, 2])
def test_loader_close_waits_for_its_worker(steps_taken):
    """``close`` returns only once the prefetch thread has ended (on the
    card a thread still inside ``pin_memory`` at exit aborts the process),
    also for a loader closed before its first batch, as a resumed run
    with nothing left to do closes it."""
    loader = ShardedLoader(MarkovLMDataset(97, 24, seed=5), 3, "cpu")
    for _ in range(steps_taken):
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()
