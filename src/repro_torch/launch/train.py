"""Training entry point (the port's counterpart of ``repro/launch/train.py``): the
train step of :func:`repro_torch.launch.steps.build_train_step` in the
fault-tolerant :class:`repro_torch.runtime.Trainer`, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke --steps 50 --device cpu

Without ``--device`` it runs on the card.  Every registered arch trains
(``attn``, ``local``, ``moe``, ``rec`` and ``ssm`` stacks, each kernel of
them with its hand-written backward), on one device: ``--data`` and
``--model`` stay 1.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b --smoke --steps 20
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=1, help="data-parallel axis (1 in this slice)")
    ap.add_argument("--model", type=int, default=1, help="model-parallel axis (1 in this slice)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="checkpoints/train",
                    help="checkpoint directory; a run resumes from the latest checkpoint found there")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.runtime import Trainer, TrainerConfig

    if args.data != 1 or args.model != 1:
        ap.error("--data/--model > 1 (sharded training over a mesh) comes with the distribution slice; "
                 "train with --data 1 --model 1 on one device")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", seq_len=args.seq_len, global_batch=args.batch, step="train")

    def log(step, m):
        print(f"step {step:6d}  loss {m['loss']:.4f}  {m['step_time_s']*1e3:.0f} ms", flush=True)

    tr = Trainer(
        cfg, cell, args.device,
        TrainerConfig(
            num_steps=args.steps, checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.ckpt, lr=args.lr, log_every=10,
        ),
        on_metrics=log,
    )
    out = tr.run()
    if out["final_loss"] is None:  # resumed from a checkpoint at (or past) --steps: nothing ran
        print(f"finished: step {out['final_step']}, nothing to run (the checkpoint in {args.ckpt} is at "
              f"step {out['final_step']}), restarts {out['restarts']}", flush=True)
    else:
        print(f"finished: step {out['final_step']}, loss {out['final_loss']:.4f}, "
              f"restarts {out['restarts']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
