"""Training entry point (the port's counterpart of ``repro/launch/train.py``): the
train step of :func:`repro_torch.launch.steps.build_train_step` in the
fault-tolerant :class:`repro_torch.runtime.Trainer`, on one device or on a
``(data, model)`` mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --steps 50 --device cpu

Without ``--device`` it runs on the card.  Every registered arch trains
(``attn``, ``local``, ``moe``, ``rec`` and ``ssm`` stacks, each kernel of
them with its hand-written backward).  Under ``torchrun`` the ranks make a
``(--data, --model)`` mesh and train the sharded step (``--strategy tp``:
each leaf on ``model`` as the reference places it, dense leaves gathered
whole before use, the experts expert-parallel; ``fsdp``: every leaf split
over all ranks); the world size must be ``--data x --model``, and without a
launcher both stay 1.  On the CPU the ranks talk over gloo:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-moe-235b-a22b --smoke --steps 3 --data 2 --model 2 --strategy tp --device cpu
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=1, help="data-parallel axis of the mesh (torchrun ranks)")
    ap.add_argument("--model", type=int, default=1, help="model axis of the mesh (torchrun ranks)")
    ap.add_argument("--strategy", choices=("tp", "fsdp"), default="tp",
                    help="the mesh's placement: tp (the reference's default) or fsdp")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="checkpoints/train",
                    help="checkpoint directory; a run resumes from the latest checkpoint found there")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.runtime import Trainer, TrainerConfig

    if args.data < 1 or args.model < 1:
        ap.error(f"--data and --model must be >= 1, got {args.data}, {args.model}")
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if (world or 1) != args.data * args.model:
        ap.error(f"a ({args.data}, {args.model}) mesh runs one rank per process: launch it with "
                 f"torchrun --nproc-per-node {args.data * args.model} (WORLD_SIZE is {world or 'unset'})")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", seq_len=args.seq_len, global_batch=args.batch, step="train")
    if world and args.batch % args.data:
        ap.error(f"--batch {args.batch} does not split over --data {args.data}")
    target, lead = args.device, True
    if world:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import backend_for, make_host_mesh, rank_device

        device = rank_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device), init_method="env://")
        target, lead = make_host_mesh(args.data, args.model, device), dist.get_rank() == 0

    def log(step, m):
        if lead:
            print(f"step {step:6d}  loss {m['loss']:.4f}  {m['step_time_s']*1e3:.0f} ms", flush=True)

    try:
        tr = Trainer(
            cfg, cell, target,
            TrainerConfig(
                num_steps=args.steps, checkpoint_every=args.checkpoint_every,
                checkpoint_dir=args.ckpt, lr=args.lr, log_every=10, strategy=args.strategy,
            ),
            on_metrics=log,
        )
        out = tr.run()
    finally:
        if world:
            dist.destroy_process_group()
    if not lead:
        return 0
    if out["final_loss"] is None:  # resumed from a checkpoint at (or past) --steps: nothing ran
        print(f"finished: step {out['final_step']}, nothing to run (the checkpoint in {args.ckpt} is at "
              f"step {out['final_step']}), restarts {out['restarts']}", flush=True)
    else:
        print(f"finished: step {out['final_step']}, loss {out['final_loss']:.4f}, "
              f"restarts {out['restarts']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
