"""Fault tolerance with the PyTorch port: train on a (2, 2) mesh of ranks,
inject a failure, restart from the atomic checkpoint, then lose half the
ranks and continue on an elastically re-shaped (1, 2) mesh of the survivors
(the counterpart of ``examples/elastic_restart.py``).

On the CPU the ranks are gloo processes this script spawns (4, then 2):

    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu

On the card (one H100 a machine) the same two phases run at one rank: a
(1, 1) mesh, then a fresh one-rank group rebuilt by ``elastic_mesh``:

    PYTHONPATH=src python examples/elastic_restart_torch.py
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

ARCH = "starcoder2-3b"


def phase1(rank: int, world: int, d: str, shape, device: str, steps: int, every: int, fail: int) -> None:
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.mesh import backend_for, make_host_mesh, rank_device
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    dev = rank_device(None if device == "cuda" else device)
    dist.init_process_group(backend_for(dev), init_method=f"file://{d}/rendezvous1", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*shape, device=dev)
        if rank == 0:
            print(f"phase 1: training on mesh {mesh.shape}, failure injected at step {fail}", flush=True)
        tr = Trainer(get_smoke_config(ARCH), ShapeCell("demo", 64, 8, "train"), mesh,
                     TrainerConfig(num_steps=steps, checkpoint_every=every, checkpoint_dir=f"{d}/ckpt", log_every=every),
                     failure_injector=FailureInjector([fail]),
                     on_metrics=lambda s, m: rank == 0 and print(f"  step {s}: loss {m['loss']:.4f}", flush=True))
        out = tr.run()
        if rank == 0:
            print(f"  finished step {out['final_step']} with {out['restarts']} restart(s) (recovered from the "
                  f"step-{(fail // every) * every} checkpoint)", flush=True)
    finally:
        dist.destroy_process_group()


def phase2(rank: int, world: int, d: str, model: int, device: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.mesh import rank_device
    from repro_torch.runtime.elastic import reshard_after_failure

    cfg = get_smoke_config(ARCH)
    dev = rank_device(None if device == "cuda" else device)
    try:
        st = reshard_after_failure(cfg, ShapeCell("demo", 64, 8, "train"), CheckpointManager(f"{d}/ckpt", cfg=cfg, train=True),
                                   n_healthy=world, model_axis=model, device=dev,
                                   init_method=f"file://{d}/rendezvous2", rank=rank)
        if rank == 0:
            print(f"  restored step {st.step} onto mesh {st.mesh.shape}", flush=True)
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 64)).astype(np.int32))
        _, _, step, m = st.step_fn(st.params, st.opt_state, st.step, toks)
        if rank == 0:
            print(f"  continued training: step {step} loss {float(m['loss']):.4f}", flush=True)
    finally:
        dist.destroy_process_group()


def _spawn(target, world: int, *args) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    if any(p.exitcode != 0 for p in procs):
        raise SystemExit(f"a rank failed: exit codes {[p.exitcode for p in procs]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (one rank, the default) or cpu (4 gloo ranks, then 2)")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=9)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        run = (args.steps, args.checkpoint_every, args.fail_at)
        if args.device == "cpu":
            _spawn(phase1, 4, d, (2, 2), "cpu", *run)
            print("phase 2: 2 of 4 ranks lost -> elastic re-shard to (data=1, model=2)", flush=True)
            _spawn(phase2, 2, d, 2, "cpu")
        else:
            phase1(0, 1, d, (1, 1), args.device, *run)
            print("phase 2: the rank's group rebuilt -> elastic re-shard to (data=1, model=1)", flush=True)
            phase2(0, 1, d, 1, args.device)
    print("done: checkpoint/restart + elastic re-shard verified", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
