"""Batched serving example on the PyTorch/CUDA port (the counterpart of
``examples/serve_lm.py``): submit mixed-length prompts to the
continuous-batching server (the EIM process-runner analogue, paper §4.6)
and report TTFT / throughput.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b \
          [--device cpu]
"""
import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models.params import init_params
from repro_torch.serve.server import ContinuousBatchServer, StaticBatchServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=[a for a in configs.ALIASES
                             if not (configs.get_smoke(a).is_encdec
                                     or configs.get_smoke(a).frontend)])
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--precision", choices=("float", "int8"),
                    default="float")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # the reduced config (head dim 16), in float32 on the CPU
    cfg = configs.get_smoke(args.arch)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    if args.engine == "static":
        server = StaticBatchServer(cfg, params, batch_size=args.slots,
                                   max_prompt=args.prompt_len,
                                   max_new_tokens=args.max_new,
                                   precision=args.precision, device=device)
    else:
        server = ContinuousBatchServer(
            cfg, params, slots=args.slots, max_prompt=args.prompt_len,
            max_new_tokens=args.max_new, precision=args.precision,
            device=device)
    rng = np.random.RandomState(0)
    # mixed-length workload: short and long prompts, varied budgets
    lens = [rng.randint(4, args.prompt_len + 1) for _ in range(args.requests)]
    budgets = [int(rng.randint(2, args.max_new + 1))
               for _ in range(args.requests)]
    reqs = server.submit(
        [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lens],
        max_new_tokens=budgets)
    metrics = server.run()
    print(json.dumps(metrics, indent=1))
    print("first request generated:", reqs[0].tokens)


if __name__ == "__main__":
    main()
