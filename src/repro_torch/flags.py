"""Performance flags (default off, so the recorded figures stay
reproducible): the counterpart of ``repro.flags``.

bf16_params  : cast the float32 master weights of two or more dimensions
               to the activation dtype once at the train step's entry
               (``models/transformer.py::maybe_cast_params``); gradients
               still reach the f32 masters (mixed precision).
bf16_attn_p  : take the softmax probabilities in V's dtype for the PV
               product of the plain attention (``kernels/ref.py``); sums
               stay f32.  The reference honours it only in its jnp chunked
               attention and never in its Pallas kernel; likewise the
               port's CUDA kernels ignore it (the bf16 kernels already
               split P into bf16 hi + lo parts).

The reference's third flag, ``kernel_path`` (and ``$REPRO_KERNEL_PATH``),
is not ported: the port's dispatch follows the tensor's device and
nothing else, so ``set_flags(kernel_path=...)`` raises ``KeyError``, as it
does for any unknown flag.
"""
from __future__ import annotations

FLAGS = {
    "bf16_params": False,
    "bf16_attn_p": False,
}


def set_flags(**kw) -> None:
    for k, v in kw.items():
        if k not in FLAGS:
            raise KeyError(k)
        FLAGS[k] = v


def get(name: str):
    return FLAGS[name]
