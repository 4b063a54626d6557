"""The dry run's count against a run on the card: a small train step
(internlm2 at smoke widths with heads of 128, bf16 activations, f32
masters, remat "full", two microbatches) traced on ``meta`` and run on
the card under the same ``StepCounter``.  Skipped without a GPU (marker
``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_dryrun_cuda.py

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.  ``chip_smoke.py`` phase 17 repeats the
check at full width.

The counts are functions of shapes alone, so the FLOPs, the kernel calls
and the bytes of each op must be equal, exactly; the card's kernels must
have launched as many times as the trace called them.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.core.arch import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.params import init_params
from repro_torch.roofline.collect import StepCounter


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _config():
    return dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                               d_model=256, n_heads=2, n_kv_heads=1,
                               head_dim=128)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_trace_counts_the_card_run(cuda_device, kind):
    cfg = _config()
    shape = ShapeConfig("small", 256, 4, kind)
    n_micro = 2 if kind == "train" else 1
    meta = StepCounter()
    dryrun.trace_step(cfg, shape, meta, n_micro=n_micro)

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen, cuda_device, dtype=torch.float32,
                         trainable=kind == "train")
    inputs = api.synthetic_inputs(cfg, shape.global_batch, shape.seq_len,
                                  gen, train=kind == "train",
                                  device=cuda_device)
    for name in ("flash_attention", "flash_attention_bwd"):
        ops.fa.LAUNCHES[name] = 0
    card = StepCounter()
    dryrun.trace_step(cfg, shape, card, n_micro=n_micro, params=params,
                      inputs=inputs)
    torch.cuda.synchronize()
    assert card.costs.flops == meta.costs.flops > 0
    assert card.costs.bytes_accessed == meta.costs.bytes_accessed
    assert card.costs.bytes_min == meta.costs.bytes_min
    assert dict(card.launches) == dict(meta.launches)
    # the trace weights the microbatch loop: the card ran its body once
    fwd = ops.fa.LAUNCHES["flash_attention"]
    assert fwd * n_micro == meta.launches["flash_attention"]
    assert ops.fa.LAUNCHES["flash_attention_bwd"] * n_micro == \
        meta.launches.get("flash_attention_bwd", 0)
