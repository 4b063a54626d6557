"""Target-hardware model: one NVIDIA H100 SXM card (the 'target device
database' of the pod estimates).

The Edge Impulse analogue: the platform holds a model of each target
(clock, SRAM and flash for a Cortex-M; peak rate, memory rate and memory
for a card) and scores a candidate deployment against it *before*
touching the hardware.  The fields are those ``roofline/model.py``
reads, under the reference's names (``repro.roofline.hw.ChipModel``), so
that module stays a copy of the reference's.  The figures are the H100 SXM's datasheet rates, as ``PERF.md`` §3 gives
them: 989 TFLOP/s dense bf16 on the tensor cores, 1,979 TOPS int8, 3.35
TB/s of HBM3, and its memory as ``torch.cuda.get_device_properties(0).
total_memory`` reports it on an NVIDIA H100 80GB HBM3 (85,017,493,504
bytes, 79.18 GiB; ``chip_smoke.py`` checks it), NVLink 4 at 450 GB/s a
direction.  On one card no collective moves a byte, so the link term
multiplies zero.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipModel:
    name: str = "h100"
    peak_flops_bf16: float = 989e12        # FLOP/s, dense, tensor cores
    hbm_bandwidth: float = 3.35e12         # bytes/s
    hbm_bytes: int = 85_017_493_504        # the total_memory torch reports
    ici_bandwidth: float = 450e9           # NVLink 4, bytes/s a direction


H100 = ChipModel()

# the int8 path (quantized serving, paper C5): 1,979 TOPS dense
H100_INT8 = ChipModel(name="h100-int8", peak_flops_bf16=1979e12)
