"""Three-term roofline from a traced step (``launch/dryrun.py``).

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM rate
    collective = collective bytes / link rate

The counterpart of ``repro.roofline.model``, with the same arithmetic;
``finalize`` defaults to the H100 model (``roofline/hw.py``).  The FLOPs
and bytes are per device: the step is traced for one device's share
(``roofline/collect.py::StepCounter``).  ``model_flops`` is the useful
work of a step (6·N·D for training, 2·N·D for inference), so
``model_flops / FLOPs`` shows how much of the traced compute is useful
(remat recompute lowers it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.arch import ArchConfig, ShapeConfig
from repro_torch.roofline.hw import H100, ChipModel


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # raw per-device measurements
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float          # ring bytes per device
    collective_detail: Dict[str, Dict[str, float]]
    per_device_hbm: float            # bytes (args + temps + outputs)
    hlo_bytes_min: float = 0.0       # products, kernels, copies only
    # derived
    t_compute: float = 0.0
    t_memory: float = 0.0            # upper bound (every op's traffic)
    t_memory_min: float = 0.0        # lower bound (unfusable traffic)
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    roofline_fraction: float = 0.0
    fits_hbm: bool = True
    note: str = ""

    def finalize(self, chip: ChipModel = H100) -> "RooflineReport":
        self.t_compute = self.hlo_flops / chip.peak_flops_bf16
        self.t_memory = self.hlo_bytes / chip.hbm_bandwidth
        self.t_memory_min = self.hlo_bytes_min / chip.hbm_bandwidth
        self.t_collective = self.collective_bytes / chip.ici_bandwidth
        # judged against the memory LOWER bound: the upper bound counts
        # elementwise traffic a fusing compiler would elide
        terms = {"compute": self.t_compute, "memory": self.t_memory_min,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.hlo_flops > 0:
            self.useful_flops_ratio = (
                self.model_flops / self.n_chips / self.hlo_flops)
        t_total = max(self.t_compute, self.t_memory_min, self.t_collective)
        if t_total > 0 and self.model_flops > 0:
            # fraction of the chip's peak achieved on *useful* model flops
            self.roofline_fraction = (
                self.model_flops / self.n_chips / t_total
                / chip.peak_flops_bf16)
        self.fits_hbm = self.per_device_hbm <= chip.hbm_bytes
        return self

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_memory_min_s": round(self.t_memory_min, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": round(self.useful_flops_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
            "hbm_gib": round(self.per_device_hbm / 2**30, 3),
            "fits_hbm": self.fits_hbm,
        }


def attention_score_traffic(cfg: ArchConfig, shape: ShapeConfig,
                            n_chips: int) -> float:
    """Per-device bytes of score-matrix traffic that a flash kernel keeps
    on chip (the QK write, softmax read, P write and P read, about 16
    bytes an element in f32; the backward about two passes more): the
    traffic a plain (unfused) attention would move, by the reference's
    formula."""
    if not cfg.uses_attention or shape.kind == "decode":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        s_enc = s // cfg.enc_seq_divisor
        elems = (cfg.n_enc_layers * s_enc * s_enc
                 + cfg.n_layers * (s * s + s * s_enc)) * b * cfg.n_heads
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        elems = n_attn * b * cfg.n_heads * s * s
    elif cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        n_groups = cfg.n_layers // (r + 1)
        n_global = n_groups
        n_local = cfg.n_layers - n_global
        w = cfg.sliding_window
        elems = b * cfg.n_heads * (n_global * s * s
                                   + n_local * s * min(2 * w, s))
    else:
        elems = cfg.n_layers * b * cfg.n_heads * s * s
    passes = 3.0 if shape.kind == "train" else 1.0
    return elems * 16.0 * passes / n_chips


def fused_adjustment(cfg: ArchConfig, shape: ShapeConfig,
                     rep: "RooflineReport",
                     chip: ChipModel = H100) -> Dict[str, float]:
    """The roofline row with the flash kernel's on-chip credit applied."""
    credit = attention_score_traffic(cfg, shape, rep.n_chips)
    bytes_fused = max(rep.hlo_bytes_min - credit, 0.0)
    t_mem_fused = bytes_fused / chip.hbm_bandwidth
    t_total = max(rep.t_compute, t_mem_fused, rep.t_collective)
    frac = 0.0
    if t_total > 0 and rep.model_flops > 0:
        frac = (rep.model_flops / rep.n_chips / t_total
                / chip.peak_flops_bf16)
    return {"t_memory_min_fused_s": round(t_mem_fused, 6),
            "roofline_fraction_fused": round(frac, 4),
            "score_traffic_credit_bytes": credit}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs for the step: 6·N·D train (3 passes of 2·N·D),
    2·N_active·D for inference; D = tokens processed this step."""
    n = cfg.param_count(active_only=False)
    n_active = cfg.param_count(active_only=True) if cfg.is_moe else n
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
