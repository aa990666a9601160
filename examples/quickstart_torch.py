"""Quickstart on the PyTorch port: train a small dense LM for a few hundred
steps through :class:`repro_torch.runtime.Trainer`, with checkpoints and
metrics: the end-to-end driver.  It runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py --steps 200 --d-model 512
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 40 --d-model 64 --layers 2

The model is Qwen3-32B's smoke config (dense, QK-norm) resized by
``--d-model`` and ``--layers``, with a vocabulary of 4,096; pass
``--d-model 768 --layers 12`` for the ~100M configuration.  A run resumes
from the latest checkpoint in ``--ckpt``.
"""
import argparse
import dataclasses

from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="checkpoints/quickstart_torch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    base = get_smoke_config("qwen3-32b")
    cfg = dataclasses.replace(
        base,
        name="quickstart-lm",
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=max(4, args.d_model // 64),
        num_kv_heads=max(2, args.d_model // 128),
        d_ff=args.d_model * 4,
        vocab_size=4096,
    )
    cell = ShapeCell("quickstart", seq_len=args.seq_len, global_batch=args.batch, step="train")

    def log(step, metrics):
        print(
            f"step {step:5d}  loss {metrics['loss']:.4f}  ce {metrics['ce']:.4f}  "
            f"grad_norm {metrics['grad_norm']:.3f}  {metrics['step_time_s']*1e3:.0f} ms/step"
        )

    tr = Trainer(
        cfg, cell, args.device,
        TrainerConfig(
            num_steps=args.steps, checkpoint_every=max(args.steps // 4, 1),
            checkpoint_dir=args.ckpt, log_every=10, lr=args.lr,
        ),
        on_metrics=log,
    )
    print(f"model: {cfg.name}  params={cfg.num_params()/1e6:.1f}M  device={tr.device}")
    out = tr.run()
    final = "none (resumed at the last step)" if out["final_loss"] is None else f"{out['final_loss']:.4f}"
    print(f"done: step={out['final_step']}  final loss={final}  restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
