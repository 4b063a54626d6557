"""Port parity: the PyTorch attention path against the JAX package's
flash-decode kernels.

On the CPU, ``repro_torch.kernels.ops.decode_attention`` /
``chunk_attention`` run their plain versions (``kernels/ref.py``).  They
are held against ``repro.kernels.ops.*`` with ``force="interpret"`` (the
Pallas kernels in interpret mode) and ``force="ref"`` at atol 1e-5, in
float32: both sides compute f32 softmax attention over the same inputs,
so they differ only by summation order.

Cases: GQA ratios G in {1, 2, 4}; per-slot kv_len in {0, partial, S};
stored position −1 (left pad); pad query rows; capacities that are no
multiple of 64; sliding windows (the kernels take them, the serving path
passes 0).  An empty slot and a pad query row must be exact zeros.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` (skipped without a GPU) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ATOL = 1e-5


def _decode_case(rng, b, s, hq, hkv, d, kv_lens, pads):
    """Row i holds ``kv_lens[i]`` entries (−1 positions beyond), the first
    ``pads[i]`` of them left-pad (−1); the query sits at the last one."""
    q = rng.randn(b, 1, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    for i, (n, pad) in enumerate(zip(kv_lens, pads)):
        pos[i, pad:n] = np.arange(n - pad)
    q_pos = np.maximum(np.array(kv_lens) - np.array(pads) - 1, 0) \
        .astype(np.int32)
    return q, k, v, q_pos, pos, np.asarray(kv_lens, np.int32)


def _chunk_case(rng, b, c, s, hq, hkv, d, fills, reals):
    """Row i holds ``fills[i]`` live entries at positions 0..fills−1; the
    chunk's ``reals[i]`` real queries sit at the tail positions, the pad
    query rows beyond at −1."""
    q = rng.randn(b, c, hq, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    qpos = np.full((b, c), -1, np.int32)
    for i, (n, r) in enumerate(zip(fills, reals)):
        pos[i, :n] = np.arange(n)
        qpos[i, :r] = np.arange(n - r, n)
    return q, k, v, qpos, pos, np.asarray(fills, np.int32)


def _both(fn_name, arrays, window, kv_len_given=True):
    """Port (CPU plain path) and JAX (interpret, ref) on the same inputs."""
    q, k, v, qp, pos, kvl = arrays
    kw = dict(window=window)
    t_kw = dict(kw, kv_len=torch.from_numpy(kvl) if kv_len_given else None)
    j_kw = dict(kw, kv_len=jnp.asarray(kvl) if kv_len_given else None)
    port = getattr(tops, fn_name)(
        *(torch.from_numpy(a) for a in (q, k, v, qp, pos)), **t_kw).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, qp, pos)]
    interp = np.asarray(getattr(jops, fn_name)(*jargs, force="interpret",
                                               **j_kw))
    jref = np.asarray(getattr(jops, fn_name)(*jargs, force="ref", **j_kw))
    return port, interp, jref


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("s", [24, 72])
@pytest.mark.parametrize("hkv", [4, 2, 1])      # GQA ratios 1, 2, 4
def test_decode_attention_matches_jax(hkv, s, window):
    rng = np.random.RandomState(0)
    arrays = _decode_case(rng, 4, s, 4, hkv, 16, kv_lens=[0, 3, s, 10],
                          pads=[0, 1, 2, 3])
    port, interp, jref = _both("decode_attention", arrays, window)
    np.testing.assert_allclose(port, interp, atol=ATOL)
    np.testing.assert_allclose(port, jref, atol=ATOL)
    assert np.all(port[0] == 0)       # kv_len == 0: exact zeros


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("s", [24, 72])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_chunk_attention_matches_jax(hkv, s, window):
    rng = np.random.RandomState(1)
    arrays = _chunk_case(rng, 3, 8, s, 4, hkv, 16, fills=[8, s, 13],
                         reals=[8, 5, 2])
    port, interp, jref = _both("chunk_attention", arrays, window)
    np.testing.assert_allclose(port, interp, atol=ATOL)
    np.testing.assert_allclose(port, jref, atol=ATOL)
    assert np.all(port[1, 5:] == 0)   # pad query rows: exact zeros
    assert np.all(port[2, 2:] == 0)


@pytest.mark.parametrize("fn_name", ["decode_attention", "chunk_attention"])
def test_attention_unbounded_matches_jax(fn_name):
    """kv_len=None reads every entry; masking alone decides validity."""
    rng = np.random.RandomState(2)
    if fn_name == "decode_attention":
        arrays = _decode_case(rng, 2, 17, 4, 2, 8, kv_lens=[5, 17],
                              pads=[0, 2])
    else:
        arrays = _chunk_case(rng, 2, 4, 17, 4, 2, 8, fills=[6, 17],
                             reals=[4, 3])
    port, interp, jref = _both(fn_name, arrays, 0, kv_len_given=False)
    np.testing.assert_allclose(port, interp, atol=ATOL)
    np.testing.assert_allclose(port, jref, atol=ATOL)


def test_chunk_c1_is_decode():
    """Decode is the C == 1 case of chunk attention, bit for bit."""
    rng = np.random.RandomState(3)
    q, k, v, qp, pos, kvl = (torch.from_numpy(a) for a in _decode_case(
        rng, 4, 24, 4, 2, 16, kv_lens=[0, 3, 24, 10], pads=[0, 1, 2, 3]))
    dec = tops.decode_attention(q, k, v, qp, pos, kv_len=kvl)
    chk = tops.chunk_attention(q, k, v, qp[:, None], pos, kv_len=kvl)
    assert torch.equal(dec, chk)


def test_kv_block_size_matches_jax():
    for cap in range(1, 1100):
        for block_k in (128, 64):
            assert tfd.kv_block_size(cap, block_k) == \
                jfd.kv_block_size(cap, block_k), (cap, block_k)
