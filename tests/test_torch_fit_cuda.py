"""Slice 6 part 1 on the card: an ``Impulse.fit`` on the card against the
same fit on the CPU, and the calibrated int8 projection (``quant_matmul``
with ``activations="calibrated"``) bitwise against the CPU's.  Skipped
without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_fit_cuda.py

This file imports neither JAX nor the JAX package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import blocks as tcb
from repro_torch.core import quantize as tq
from repro_torch.core import tree
from repro_torch.core.impulse import Impulse
from repro_torch.data import synthetic
from repro_torch.kernels import int8_matmul as tim
from repro_torch.kernels import mel_frontend as tmf
from repro_torch.kernels import ops

LR, EPOCHS, BATCH = 1e-3, 2, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fit_on_the_card_matches_the_cpu(cuda_device):
    """The quickstart-shaped Impulse (MFCC + conv1d stack) fitted 2 epochs
    on 20 clips from the same weights: one ``mel_frontend`` launch a step;
    loss and accuracy history and logits within chip_smoke.py's limits
    for the quickstart's fit (2^-22 relative, 2^-16: f32 in another
    summation order, which Adam's division by sqrt(v) amplifies), weights
    within the Adam bound (2 x lr x steps)."""
    samples = synthetic.keyword_audio(n_per_class=5, n_classes=4,
                                      n_samples=4000, seed=1)
    xs = np.stack([s.data for s in samples])
    ys = np.asarray([s.label for s in samples])
    dsp = tcb.make_dsp_block("mfcc", n_mels=32, n_coeffs=10)
    learn = tcb.make_learn_block("conv1d-stack", n_blocks=2, ch_first=16,
                                 ch_last=32, n_classes=4)
    cpu = Impulse(dsp, learn, input_shape=4000, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    card = Impulse(dsp, learn, input_shape=4000, device=cuda_device,
                   params=tree.map_tree(lambda t: t.to(cuda_device),
                                        cpu.params))
    tmf.reset_launches()
    got = card.fit((xs, ys), epochs=EPOCHS, batch_size=BATCH,
                   lr=LR)["history"]
    steps = EPOCHS * -(-len(xs) // BATCH)
    assert tmf.LAUNCHES["mel_frontend"] == steps
    want = cpu.fit((xs, ys), epochs=EPOCHS, batch_size=BATCH,
                   lr=LR)["history"]
    for a, b in zip(got, want):
        for k in ("loss", "acc"):
            assert abs(a[k] - b[k]) <= 2.0 ** -22 * abs(b[k]), (a, b)
    for a, b in zip(tree.leaves(card.params), tree.leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= 2 * LR * steps
    gap = (card.logits(xs).cpu() - cpu.logits(xs)).abs().max()
    assert float(gap) <= 2.0 ** -16


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64])
def test_calibrated_int8_matmul_bitwise(cuda_device, m):
    """A stacked (2, K, N) weight quantized with a per-layer amax; layer
    1's calibrated projection through the kernel equals the CPU's plain
    path bitwise, decode (M 4) and chunk (M 64) shapes, one launch."""
    gen = torch.Generator().manual_seed(m)
    w = torch.randn(2, 512, 384, generator=gen)
    x = torch.randn(m, 512, generator=gen) * 3
    qt = tq._leaf_qtensor(w)
    qt = qt._replace(amax=torch.tensor([2.5, 4.0]))
    layer = tq.QTensor(qt.q[1], qt.scale[1], qt.amax[1])
    policy = dataclasses.replace(tq.INT8, activations="calibrated")
    want = ops.quant_matmul(x, layer, policy=policy)
    on_card = tq.QTensor(*(t.to(cuda_device) for t in layer))
    before = tim.LAUNCHES["int8_matmul"]
    got = ops.quant_matmul(x.to(cuda_device), on_card, policy=policy)
    torch.cuda.synchronize()
    assert tim.LAUNCHES["int8_matmul"] == before + 1
    assert torch.equal(got.cpu(), want)
    dynamic = ops.quant_matmul(x, layer._replace(amax=None), policy=policy)
    assert not torch.equal(dynamic, want)
