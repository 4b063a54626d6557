"""End-to-end training on the PyTorch/CUDA port: a ~100M-param LM for a
few hundred steps (the counterpart of ``examples/train_lm.py``).

data pipeline → grad-accumulation train step → AdamW → checkpoints →
crash-safe resume → best-model restore, on the card unless ``--device
cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 150
      [--device cpu] (--d-model 768 --layers 12 reaches ~106M params; the
      default is a ~60M config)
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.arch import ArchConfig
from repro_torch.data.synthetic import lm_batches, token_stream
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default="experiments/torch_train_lm.json")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = ArchConfig(
        name="examples-lm", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 128,
        d_ff=4 * args.d_model, vocab_size=args.vocab,
        vocab_pad_multiple=256)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device, trainable=True)
    n = sum(p.numel() for p in params.parameters())
    print(f"model: {args.layers}L d={args.d_model} -> {n/1e6:.1f}M params"
          f" on {device}")

    tokens = token_stream(400_000, cfg.vocab_size, seed=1)
    batches = lm_batches(tokens, args.batch, args.seq)
    step = make_train_step(cfg, n_microbatch=args.micro, remat="none",
                           opt=AdamWConfig(lr=args.lr))
    trainer = Trainer(step, params, adamw_init(params),
                      ckpt_dir=Path(args.ckpt_dir), device=device,
                      config=TrainerConfig(total_steps=args.steps,
                                           checkpoint_every=50,
                                           log_every=10))
    if args.resume and trainer.maybe_resume():
        print(f"resumed at step {trainer.step}")
    t0 = time.time()
    result = trainer.run(iter(batches))
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    summary = {
        "params_m": n / 1e6, "steps": args.steps, "device": str(device),
        "first_loss": result["history"][0]["loss"],
        "final_loss": result["final_loss"],
        "best": result["best"],
        "tokens_per_s": toks / dt,
        "unigram_entropy_bound": float(np.log(args.vocab)),
    }
    print(json.dumps(summary, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {**summary, "history": result["history"]}, indent=1))


if __name__ == "__main__":
    main()
