"""The paper's evaluation models (§5.1, MLPerf Tiny tasks) in PyTorch:

* DS-CNN: depthwise-separable CNN for keyword spotting (Sørensen 2020),
* MobileNetV1-0.25: visual wake words binary classifier,
* CIFAR CNN: small convnet for image classification,
* conv1d stacks: the EON-Tuner search family from Table 3
  ("Nx conv1d (a to b)": N conv1d blocks widening a→b).

The counterpart of ``repro.models.kws``.  Parameters are plain trees
(dicts and lists of tensors) in the JAX package's layouts: convolution
weights HWIO (2-D) and WIO (1-D), dense weights (in, out), batch norm as
folded ``scale``/``offset``.  Inputs and outputs are laid out as there
too: features (B, frames, n_feat), images NHWC.  Inside, activations run
channels first for ``F.conv2d``/``F.conv1d``; each weight is viewed in
PyTorch's (out, in, ...) order at the call.

Padding is XLA's ``SAME``: ``total = max((ceil(n / s) - 1) * s + k - n,
0)``, ``total // 2`` before and the rest after, so a stride-2 convolution
on an even size pads one more at the end (PyTorch's ``padding="same"``
refuses stride 2).  The apply functions compute in float32: cuDNN's TF32
for float32 convolutions is turned off for their duration.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import tree

Device = Union[str, torch.device, None]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(conv, x, w, stride, groups):
    """``conv`` (F.conv1d/2d) of channels-first ``x`` with ``w`` already
    in (out, in, *k) order, SAME-padded: in the convolution itself when
    the padding is symmetric, by ``F.pad`` when it is not."""
    if 0 in x.shape[2:]:
        # SAME over no input gives no output (XLA takes it; the padded
        # size would be below the kernel for F.conv*)
        out = [-(-n // stride) for n in x.shape[2:]]
        return x.new_zeros((x.shape[0], w.shape[0], *out))
    pads = [same_padding(n, k, stride)
            for n, k in zip(x.shape[2:], w.shape[2:])]
    if all(lo == hi for lo, hi in pads):
        return conv(x, w, stride=stride, padding=tuple(lo for lo, _ in pads),
                    groups=groups)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return conv(F.pad(x, flat), w, stride=stride, groups=groups)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           groups: int = 1) -> torch.Tensor:
    """x: (B, C, H, W); w: HWIO (kh, kw, C / groups, O)."""
    return _conv(F.conv2d, x, w.permute(3, 2, 0, 1), stride, groups)


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1
           ) -> torch.Tensor:
    """x: (B, C, W); w: WIO (k, C, O)."""
    return _conv(F.conv1d, x, w.permute(2, 1, 0), stride, 1)


def batchnorm_apply(p, x: torch.Tensor) -> torch.Tensor:
    """Inference-style folded scale/offset over the channel dim (1)."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    return x * p["scale"].view(shape) + p["offset"].view(shape)


def _dense(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _f32(apply_fn):
    """Run ``apply_fn`` with cuDNN's float32 convolutions in float32 (its
    default for them is TF32), restoring the caller's setting after."""
    @functools.wraps(apply_fn)
    def run(*args, **kw):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return apply_fn(*args, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return run


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * std


def _conv_init(gen, shape, device) -> torch.Tensor:
    fan_in = math.prod(shape[:-1])
    return _normal(gen, shape, (2.0 / fan_in) ** 0.5, device)


def _bn_init(c: int, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(c, device=device),
            "offset": torch.zeros(c, device=device)}


def _dense_init(gen, din: int, dout: int, device) -> Dict[str, torch.Tensor]:
    return {"w": _normal(gen, (din, dout), (1.0 / din) ** 0.5, device),
            "b": torch.zeros(dout, device=device)}


# ---------------------------------------------------------------------------
# DS-CNN (KWS)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DSCNNConfig:
    n_classes: int = 12
    n_filters: int = 64
    n_blocks: int = 4
    name: str = "ds-cnn"


def dscnn_init(cfg: DSCNNConfig, generator: torch.Generator,
               input_shape: Tuple[int, int], device: Device = None):
    dev = resolve_device(device)
    f = cfg.n_filters
    params: Dict = {
        "stem": {"w": _conv_init(generator, (10, 4, 1, f), dev),
                 "bn": _bn_init(f, dev)},
        "blocks": [],
        "head": _dense_init(generator, f, cfg.n_classes, dev),
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "dw": {"w": _conv_init(generator, (3, 3, 1, f), dev),
                   "bn": _bn_init(f, dev)},
            "pw": {"w": _conv_init(generator, (1, 1, f, f), dev),
                   "bn": _bn_init(f, dev)},
        })
    return params


@_f32
def dscnn_apply(cfg: DSCNNConfig, params, feats: torch.Tensor
                ) -> torch.Tensor:
    """feats: (B, n_frames, n_mels) -> logits (B, n_classes)."""
    x = feats[:, None]                                      # NCHW
    x = conv2d(x, params["stem"]["w"], stride=2)
    x = F.relu(batchnorm_apply(params["stem"]["bn"], x))
    for blk in params["blocks"]:
        x = conv2d(x, blk["dw"]["w"], groups=x.shape[1])
        x = F.relu(batchnorm_apply(blk["dw"]["bn"], x))
        x = conv2d(x, blk["pw"]["w"])
        x = F.relu(batchnorm_apply(blk["pw"]["bn"], x))
    return _dense(params["head"], x.mean(dim=(2, 3)))   # global avg pool


# ---------------------------------------------------------------------------
# MobileNetV1 (VWW)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MobileNetV1Config:
    n_classes: int = 2
    width_mult: float = 0.25
    name: str = "mobilenetv1"


_MBV1_PLAN = [  # (out_channels@1.0, stride)
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]


def mobilenetv1_init(cfg: MobileNetV1Config, generator: torch.Generator,
                     input_shape: Tuple[int, int, int] = (96, 96, 3),
                     device: Device = None):
    dev = resolve_device(device)
    wm = cfg.width_mult
    c_in = max(int(32 * wm), 8)
    params: Dict = {
        "stem": {"w": _conv_init(generator, (3, 3, input_shape[2], c_in),
                                 dev),
                 "bn": _bn_init(c_in, dev)},
        "blocks": [],
    }
    c = c_in
    for c_out_base, _ in _MBV1_PLAN:
        c_out = max(int(c_out_base * wm), 8)
        params["blocks"].append({
            "dw": {"w": _conv_init(generator, (3, 3, 1, c), dev),
                   "bn": _bn_init(c, dev)},
            "pw": {"w": _conv_init(generator, (1, 1, c, c_out), dev),
                   "bn": _bn_init(c_out, dev)},
        })
        c = c_out
    params["head"] = _dense_init(generator, c, cfg.n_classes, dev)
    return params


@_f32
def mobilenetv1_apply(cfg: MobileNetV1Config, params, images: torch.Tensor
                      ) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = conv2d(x, params["stem"]["w"], stride=2)
    x = F.relu(batchnorm_apply(params["stem"]["bn"], x))
    for blk, (_, stride) in zip(params["blocks"], _MBV1_PLAN):
        x = conv2d(x, blk["dw"]["w"], stride=stride, groups=x.shape[1])
        x = F.relu(batchnorm_apply(blk["dw"]["bn"], x))
        x = conv2d(x, blk["pw"]["w"])
        x = F.relu(batchnorm_apply(blk["pw"]["bn"], x))
    return _dense(params["head"], x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# CIFAR CNN (image classification)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CifarCNNConfig:
    n_classes: int = 10
    name: str = "cifar-cnn"


def cifar_cnn_init(cfg: CifarCNNConfig, generator: torch.Generator,
                   input_shape: Tuple[int, int, int] = (32, 32, 3),
                   device: Device = None):
    dev = resolve_device(device)
    return {
        "c1": {"w": _conv_init(generator, (3, 3, input_shape[2], 32), dev),
               "bn": _bn_init(32, dev)},
        "c2": {"w": _conv_init(generator, (3, 3, 32, 64), dev),
               "bn": _bn_init(64, dev)},
        "c3": {"w": _conv_init(generator, (3, 3, 64, 64), dev),
               "bn": _bn_init(64, dev)},
        "head": _dense_init(generator, 64, cfg.n_classes, dev),
    }


@_f32
def cifar_cnn_apply(cfg: CifarCNNConfig, params, images: torch.Tensor
                    ) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes); 2x2 max pools with
    VALID padding (floor mode)."""
    x = images.permute(0, 3, 1, 2)
    for name in ("c1", "c2", "c3"):
        x = conv2d(x, params[name]["w"])
        x = F.relu(batchnorm_apply(params[name]["bn"], x))
        x = F.max_pool2d(x, 2, 2)
    return _dense(params["head"], x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# conv1d stacks: the EON-Tuner Table 3 model family
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Conv1DStackConfig:
    """"Nx conv1d (a to b)": N blocks, channels geometric from a to b."""
    n_classes: int = 12
    n_blocks: int = 4
    ch_first: int = 32
    ch_last: int = 256
    kernel: int = 3
    name: str = "conv1d-stack"

    @property
    def channels(self) -> List[int]:
        if self.n_blocks == 1:
            return [self.ch_last]
        r = (self.ch_last / self.ch_first) ** (1.0 / (self.n_blocks - 1))
        return [int(round(self.ch_first * r ** i))
                for i in range(self.n_blocks)]


def conv1d_stack_init(cfg: Conv1DStackConfig, generator: torch.Generator,
                      input_shape: Tuple[int, int], device: Device = None):
    dev = resolve_device(device)
    params: Dict = {"blocks": [], "head": None}
    c = input_shape[1]
    for c_out in cfg.channels:
        params["blocks"].append(
            {"w": _conv_init(generator, (cfg.kernel, c, c_out), dev),
             "bn": _bn_init(c_out, dev)})
        c = c_out
    params["head"] = _dense_init(generator, c, cfg.n_classes, dev)
    return params


@_f32
def conv1d_stack_apply(cfg: Conv1DStackConfig, params, feats: torch.Tensor
                       ) -> torch.Tensor:
    """feats: (B, n_frames, n_feat) -> (B, n_classes); pools of 2 with
    VALID padding (floor mode)."""
    x = feats.transpose(1, 2)                               # (B, C, W)
    for blk in params["blocks"]:
        x = conv1d(x, blk["w"])
        x = F.relu(batchnorm_apply(blk["bn"], x))
        # fewer than 2 frames pool to none, as the JAX package's VALID
        # reduce_window does (its logits are then NaN, as here)
        x = F.max_pool1d(x, 2, 2) if x.shape[2] >= 2 else x[:, :, :0]
    return _dense(params["head"], x.mean(dim=2))


def count_params(params) -> int:
    return sum(int(p.numel()) for p in tree.leaves(params))


def model_macs_conv1d(cfg: Conv1DStackConfig,
                      input_shape: Sequence[int]) -> int:
    """Analytic MACs for the estimator (paper §4.4)."""
    frames, feat = input_shape
    macs, c, f = 0, feat, frames
    for c_out in cfg.channels:
        macs += f * cfg.kernel * c * c_out
        f = max(f // 2, 1)
        c = c_out
    macs += c * cfg.n_classes
    return macs
