"""Training driver: ``python -m repro_torch.launch.train [--device cpu]
[--full] --steps N --batch B --seq S --micro M --remat R
--grad-compression C``.

The counterpart of ``repro.launch.train``.  Runs on ``cuda`` unless
``--device cpu`` is given (and raises without a GPU); the smoke config by
default, ``--full`` for the published widths.  Weights are f32 masters
drawn from a seeded ``torch.Generator``; batches come from the Markov
token stream.  Checkpoint/restart, the watchdog and best-model restore
come from the ``Trainer``.  The stream's tail is never trained on: one
batch of it is scored before and after the run (the held-out loss).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data.synthetic import lm_batches, token_stream
from repro_torch.models.params import init_params
from repro_torch.models.transformer import REMAT_POLICIES, forward_train
from repro_torch.train.compression import init_residual
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def build(arch: str, *, smoke: bool, n_micro: int, lr: float,
          grad_compression: Optional[str], remat: str,
          device: torch.device):
    """(cfg, params, opt_state, train_step) on ``device``.  An enc-dec
    config raises: its audio frontend is a stub, and the token stream
    gives no frame embeddings to feed its encoder.  A frontend decoder
    (qwen2-vl) trains on the token batches as the JAX launcher does, its
    positions the default ones (three equal streams under M-RoPE)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the launcher feeds token batches alone; an enc-dec"
            " config needs frame embeddings for its encoder (the audio"
            " frontend is a stub): train it through"
            " train_step.make_train_step with api.synthetic_inputs")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device, trainable=True)
    opt_state = adamw_init(params)
    if grad_compression and grad_compression != "none":
        opt_state["residual"] = init_residual(params)
    step = make_train_step(cfg, n_microbatch=n_micro, remat=remat,
                           opt=AdamWConfig(lr=lr),
                           grad_compression=grad_compression)
    return cfg, params, opt_state, step


def held_out(tokens: np.ndarray, batch: int, seq: int,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """``batch`` windows of ``seq`` + 1 tokens from the end of ``tokens``,
    side by side, as one {tokens, labels} batch on ``device``."""
    tail = tokens[len(tokens) - batch * (seq + 1):].reshape(batch, seq + 1)
    tail = torch.from_numpy(tail).to(device)
    return {"tokens": tail[:, :-1], "labels": tail[:, 1:]}


@torch.no_grad()
def eval_loss(cfg, params, batch: Dict[str, torch.Tensor]) -> float:
    return float(forward_train(cfg, params, batch, remat="none")[0])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none", choices=REMAT_POLICIES)
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg, params, opt_state, step = build(
        args.arch, smoke=args.smoke, n_micro=args.micro, lr=args.lr,
        grad_compression=args.grad_compression, remat=args.remat,
        device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params:,} device={device}")

    n_train = 200_000
    tokens = token_stream(n_train + args.batch * (args.seq + 1),
                          cfg.vocab_size, seed=1)
    batches = lm_batches(tokens[:n_train], args.batch, args.seq)
    held = held_out(tokens, args.batch, args.seq, device)

    trainer = Trainer(step, params, opt_state,
                      ckpt_dir=Path(args.ckpt_dir),
                      config=TrainerConfig(total_steps=args.steps,
                                           checkpoint_every=args.ckpt_every,
                                           log_every=10),
                      device=device)
    if args.resume:
        resumed = trainer.maybe_resume()
        print("resumed from checkpoint" if resumed else "fresh start")
    held_before = eval_loss(cfg, params, held)
    result = trainer.run(iter(batches))
    held_after = eval_loss(cfg, trainer.params, held)
    print(f"final loss {result['final_loss']:.4f} "
          f"(best {result['best']['loss']:.4f} @ {result['best']['step']})"
          f"; held-out loss {held_before:.4f} -> {held_after:.4f}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"arch": cfg.name, "final": result["final_loss"],
             "best": result["best"], "steps": args.steps,
             "held_out": [held_before, held_after],
             "history_tail": result["history"][-5:]}, indent=1))


if __name__ == "__main__":
    main()
