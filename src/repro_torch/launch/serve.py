"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Runs a serving engine over synthetic prompts on the selected arch
(``internlm2-1.8b``, ``granite-3-8b``, ``llama3.2-3b``, ``gemma3-4b``,
``falcon-mamba-7b``, ``zamba2-2.7b``, ``phi3.5-moe-42b-a6.6b`` or
``dbrx-132b``), on the card unless
``--device cpu`` is given: the smoke config by default,
the full config with ``--full`` (random weights drawn from a seeded
``torch.Generator`` on the device; nothing is downloaded).
``--engine static`` selects the static-batching baseline, ``--engine
paged`` the paged-KV-pool engine (``--pool-blocks`` sizes the pool below
the contiguous rectangle, so it may preempt), ``--artifact`` runs the
continuous or paged engine's decode loop from its deployment artifact
(paper C4: exported once, replayed as a CUDA graph on the card), and
``--precision int8`` serves int8 weights, activations and KV cache.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models.params import init_params
from repro_torch.serve.server import (ContinuousBatchServer, PagedBatchServer,
                                      StaticBatchServer)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--engine", choices=("continuous", "static", "paged"),
                    default="continuous")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged engine: KV blocks in the pool (default:"
                         " the contiguous rectangle's count)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="chunked pad-free admission: prompt tokens per"
                         " prefill chunk step")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--artifact", action="store_true",
                    help="decode via the deployed CompiledArtifact (a CUDA"
                         " graph on the card)")
    ap.add_argument("--precision", choices=("float", "int8"),
                    default="float",
                    help="int8: QTensor weights, dynamic activation quant"
                         " and an Int8KV cache")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_smoke(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    common = dict(max_prompt=args.prompt_len,
                  prefill_chunk=args.prefill_chunk,
                  max_new_tokens=args.max_new, precision=args.precision,
                  device=device)
    if args.engine == "static":
        server = StaticBatchServer(cfg, params, batch_size=args.slots,
                                   **common)
    elif args.engine == "paged":
        server = PagedBatchServer(cfg, params, slots=args.slots,
                                  pool_blocks=args.pool_blocks,
                                  use_artifact=args.artifact, **common)
    else:
        server = ContinuousBatchServer(cfg, params, slots=args.slots,
                                       use_artifact=args.artifact, **common)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]
    server.submit(prompts)
    metrics = server.run()
    print(json.dumps(metrics, indent=1))


if __name__ == "__main__":
    main()
