"""Static resource estimation (paper C2 / §4.4): the MCU half.

Edge Impulse predicts latency / RAM / flash per *target device* before
deployment (Renode + device benchmarks).  For the MCU targets (the
paper's Table 1 boards) the model is analytic:
  latency = MACs / effective-MACs-per-second (per-board constant),
  RAM    = peak activation working set (+ interpreter arena overhead),
  flash  = weight bytes (+ runtime code size).
The interpreter-vs-EON split reproduces Table 4's structure: the EON path
drops the interpreter arena factor and most runtime code.

The counterpart of ``repro.core.estimator`` with its targets and
constants.  The counters read the port's own graph: one batch-1 forward
of the learn block on the ``meta`` device (shapes only, no data, no
device work) under a ``TorchDispatchMode`` that sees every ATen operation.
A convolution counts ``out.numel() x prod(w.shape[1:])`` MACs, ``w`` being
(out, in / groups, *k), so a grouped (depthwise) convolution counts its
``k`` MACs per output.  (The JAX package divides by the groups a second
time and counts no depthwise MACs at all.)  ``pod_estimate_from_report``
adapts a dry-run row (``launch/dryrun.py``: the card's roofline) into the
same ``ResourceEstimate``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tree
from repro_torch.roofline.hw import H100, ChipModel


@dataclasses.dataclass(frozen=True)
class MCUTarget:
    name: str
    clock_hz: float
    ram_bytes: int
    flash_bytes: int
    # effective multiply-accumulates per cycle (CMSIS-NN-ish int8 vs float)
    macs_per_cycle_int8: float
    macs_per_cycle_float: float
    # DSP throughput: samples processed per cycle in the MFE/MFCC path
    dsp_samples_per_cycle: float


# Paper Table 1 boards.  MAC/cycle and DSP-throughput constants are
# FITTED from the paper's own Table 2 KWS row (treating the DS-CNN as
# ~11.4 MMACs): e.g. nano int8 322.71 ms @ 64 MHz → 0.55 MAC/cycle.
TARGETS: Dict[str, MCUTarget] = {
    "nano33ble": MCUTarget("Arduino Nano 33 BLE Sense (Cortex-M4 64MHz)",
                           64e6, 256 * 1024, 1024 * 1024,
                           macs_per_cycle_int8=0.55,
                           macs_per_cycle_float=0.062,
                           dsp_samples_per_cycle=0.00177),
    "esp32": MCUTarget("ESP-EYE (Tensilica LX6 160MHz)",
                       160e6, 8 * 1024 * 1024, 4 * 1024 * 1024,
                       macs_per_cycle_int8=0.23,
                       macs_per_cycle_float=0.11,
                       dsp_samples_per_cycle=0.00033),
    "rp2040": MCUTarget("Raspberry Pi Pico (Cortex-M0+ 133MHz)",
                        133e6, 264 * 1024, 16 * 1024 * 1024,
                        macs_per_cycle_int8=0.077,
                        macs_per_cycle_float=0.015,
                        dsp_samples_per_cycle=0.0002),
}


@dataclasses.dataclass
class ResourceEstimate:
    target: str
    dsp_latency_ms: float
    nn_latency_ms: float
    ram_kb: float
    flash_kb: float
    fits: bool
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def total_latency_ms(self) -> float:
        return self.dsp_latency_ms + self.nn_latency_ms


# ---------------------------------------------------------------------------
# analytic counters
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
_MATMULS = (_aten.mm, _aten.bmm)


class _GraphCounter(TorchDispatchMode):
    """MACs of the convolutions and matmuls, and the element count of
    every buffer an operation makes (views alias their input: none).

    A ``constant_pad_nd`` whose only consumer is a convolution (the SAME
    padding ``models/kws.py`` writes before a strided convolution) is
    counted as part of that convolution, not as a buffer: XLA pads inside
    the convolution, and so does an MCU runtime."""

    def __init__(self):
        super().__init__()
        self.macs = 0
        self._sizes: List[int] = []
        # id of a pad's output -> [its index in _sizes, the tensor, None
        # until consumed, then whether only convolutions consumed it]
        self._pads: Dict[int, list] = {}

    @property
    def sizes(self) -> List[int]:
        folded = {i for i, _, conv_only in self._pads.values()
                  if conv_only is True}
        return [n for i, n in enumerate(self._sizes) if i not in folded]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        for i, a in enumerate(args):
            pad = self._pads.get(id(a)) if isinstance(a, torch.Tensor) \
                else None
            if pad is not None and pad[1] is a:
                pad[2] = pad[2] is not False and op is _aten.convolution \
                    and i == 0
        if op is _aten.convolution:
            self.macs += out.numel() * math.prod(args[1].shape[1:])
        elif op in _MATMULS:
            self.macs += out.numel() * args[0].shape[-1]
        elif op is _aten.addmm:
            self.macs += out.numel() * args[1].shape[-1]
        if not func.is_view:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if op is _aten.constant_pad_nd:
                self._pads[id(out)] = [len(self._sizes), out, None]
            self._sizes += [t.numel() for t in outs
                            if isinstance(t, torch.Tensor)]
        return out


def _trace(apply_fn: Callable, params, feats_shape: Tuple[int, ...]
           ) -> _GraphCounter:
    """One batch-1 forward of ``apply_fn(params, feats)`` on ``meta``."""
    meta = tree.map_tree(lambda t: t.detach().to("meta"), params)
    feats = torch.empty((1,) + tuple(feats_shape), device="meta")
    with torch.no_grad(), _GraphCounter() as counter:
        apply_fn(meta, feats)
    return counter


def count_macs(apply_fn: Callable, params, feats_shape: Tuple[int, ...]
               ) -> int:
    """MACs of the NN from its own graph, summing convolutions and
    matmuls."""
    return _trace(apply_fn, params, feats_shape).macs


def _peak_bytes(counter: _GraphCounter, feats_shape: Tuple[int, ...],
                dtype_bytes: int) -> int:
    sizes = [math.prod(feats_shape)] + counter.sizes
    sizes = sorted((n * dtype_bytes for n in sizes), reverse=True)
    return sizes[0] + (sizes[1] if len(sizes) > 1 else 0)


def peak_activation_bytes(apply_fn: Callable, params,
                          feats_shape: Tuple[int, ...],
                          dtype_bytes: int = 4) -> int:
    """Peak working set ≈ largest producer+consumer buffer pair (the
    two-arena model TFLM planning uses): the two largest of the input and
    every buffer an operation makes."""
    return _peak_bytes(_trace(apply_fn, params, feats_shape), feats_shape,
                       dtype_bytes)


def param_bytes(params, int8: bool = False) -> int:
    total = 0
    for leaf in tree.leaves(params):
        if int8 and leaf.dim() >= 2:
            total += leaf.numel() + 4 * leaf.shape[-1]   # int8 + scales
        else:
            total += leaf.numel() * 4
    return total


# runtime footprints (flash code + RAM arena factor), fitted to Table 4
RUNTIME = {
    "tflm": {"flash_code": 48 * 1024, "ram_factor": 1.35,
             "ram_fixed": 8 * 1024},
    "eon": {"flash_code": 14 * 1024, "ram_factor": 1.08,
            "ram_fixed": 2 * 1024},
}


def estimate_mcu(target: str, *, macs: int, dsp_samples: int,
                 weight_bytes: int, act_bytes: int, engine: str = "eon",
                 int8: bool = True) -> ResourceEstimate:
    t = TARGETS[target]
    rt = RUNTIME[engine]
    mac_rate = (t.macs_per_cycle_int8 if int8 else t.macs_per_cycle_float) \
        * t.clock_hz
    nn_ms = macs / mac_rate * 1e3
    dsp_ms = dsp_samples / (t.dsp_samples_per_cycle * t.clock_hz) * 1e3
    act = act_bytes if not int8 else act_bytes // 4 + 2048
    ram = act * rt["ram_factor"] + rt["ram_fixed"]
    flash = weight_bytes + rt["flash_code"]
    fits = ram <= t.ram_bytes and flash <= t.flash_bytes
    return ResourceEstimate(
        target=target, dsp_latency_ms=dsp_ms, nn_latency_ms=nn_ms,
        ram_kb=ram / 1024, flash_kb=flash / 1024, fits=fits,
        detail={"macs": macs, "engine": engine, "int8": int8})


def estimate_impulse(impulse, target: str, *, engine: str = "eon",
                     int8: bool = True) -> ResourceEstimate:
    """Estimate a whole Impulse (DSP + NN) for an MCU target."""
    feats_shape = impulse.dsp.feature_shape(impulse.input_shape)
    counter = _trace(impulse.learn.apply, impulse.params, feats_shape)
    act = _peak_bytes(counter, feats_shape, 4)
    wb = param_bytes(impulse.params, int8=int8)
    n_samples = (impulse.input_shape if isinstance(impulse.input_shape, int)
                 else int(np.prod(impulse.input_shape)))
    return estimate_mcu(target, macs=counter.macs, dsp_samples=n_samples,
                        weight_bytes=wb, act_bytes=act, engine=engine,
                        int8=int8)


def pod_estimate_from_report(report_row: Dict[str, Any],
                             chip: ChipModel = H100) -> ResourceEstimate:
    """Adapt a dry-run roofline row (``launch/dryrun.py``) into the common
    interface; the target is named by the chip model and the mesh
    (``h100-1x1``)."""
    t_total = max(report_row["t_compute_s"],
                  report_row.get("t_memory_min_s",
                                 report_row["t_memory_s"]),
                  report_row["t_collective_s"])
    return ResourceEstimate(
        target=f"{chip.name}-{report_row['mesh']}",
        dsp_latency_ms=0.0, nn_latency_ms=t_total * 1e3,
        ram_kb=report_row["hbm_gib"] * 1024 * 1024,
        flash_kb=0.0, fits=report_row["fits_hbm"],
        detail=dict(report_row))
