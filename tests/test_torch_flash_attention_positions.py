"""Port parity: whole-sequence attention masked by position, against the
JAX package, on the CPU.

The plain version with per-row positions (``ref.flash_attention_ref``
with ``q_pos``/``k_pos``, what ``ops.flash_attention`` runs on a CPU
tensor) against the reference's jnp cores, which mask by position:
``full_attention`` on Qwen2-VL image ties (every patch of an image on one
temporal position), packed rows (two sequences a row, positions
restarting) with pads at −1, a window, GQA and keys of another length;
``chunked_attention`` on image ties and pads; ``local_attention`` on
packed rows with a window (rows that see a key: a row that sees none
averages the reference's band there, every key here).  The plain
backward and autograd against ``jax.grad`` of ``full_attention``, a pad
row's uniform weights included.  Positions equal to the index give the
index path's output exactly.  The CUDA kernels are held against this
plain version on the card (``tests/test_torch_flash_attention_positions_
cuda.py``, ``chip_smoke.py``).  Inputs are made with numpy from a seed;
f32 throughout, tolerance 1e-5 (another summation order); gradients
1e-5 of the largest magnitude plus 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi

torch.set_num_threads(1)

ATOL = 1e-5


def _image_row(s):
    """Qwen2-VL's temporal stream over S tokens: 5 text tokens, a 1 x 4 x
    6 image (24 patches on one temporal position), text to the end."""
    pos = tapi.mrope_positions([("text", 5), ("image", (1, 4, 6)),
                                ("text", s - 29)])
    return pos[:, 0].numpy()


def _packed_row(s, cut, pad, gap=0):
    """Two sequences in one row of S: positions 0.. up to ``cut``, then
    ``gap``.. from ``cut`` on, the last ``pad`` entries −1."""
    pos = np.concatenate([np.arange(cut), gap + np.arange(s - cut)])
    if pad:
        pos[-pad:] = -1
    return pos.astype(np.int32)


def _positions(kind, b, s):
    if kind == "image":
        rows = [_image_row(s), _image_row(s) + 3]
    elif kind == "image_pads":
        rows = [_image_row(s), np.where(np.arange(s) < s - 9, _image_row(s),
                                        -1)]
    elif kind == "packed":
        rows = [_packed_row(s, s // 3, 7), _packed_row(s, s // 2, 0)]
    else:
        raise ValueError(kind)
    return np.stack(rows[:b]).astype(np.int32)


def _qkv(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, sq, hq, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# name: (positions, B, S, Hq, Hkv, D, causal, window)
FULL_CASES = {
    "image_causal": ("image", 2, 64, 4, 2, 16, True, 0),
    "image_pads_causal": ("image_pads", 2, 64, 4, 1, 32, True, 0),
    "packed_pads_causal": ("packed", 2, 60, 2, 2, 16, True, 0),
    "packed_pads_window": ("packed", 2, 60, 4, 2, 16, True, 8),
    "image_pads_bidirectional": ("image_pads", 2, 40, 2, 2, 16, False, 0),
    "image_window_g4": ("image", 1, 48, 8, 2, 16, True, 5),
}


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_plain_matches_jax_full_attention(name):
    """``ops.flash_attention`` with positions on a CPU tensor against the
    reference's ``full_attention``, every row (a pad row's mean of V
    too)."""
    kind, b, s, hq, hkv, d, causal, window = FULL_CASES[name]
    q, k, v, _ = _qkv(b, s, s, hq, hkv, d, seed=len(name))
    pos = _positions(kind, b, s)
    want = jlayers.full_attention(*_j(q, k, v, pos, pos), window=window,
                                  causal=causal)
    tq, tk, tv, tpos = _t(q, k, v, pos)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                               q_pos=tpos, k_pos=tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_keys_of_another_length_by_position():
    """Sq != Skv under a causal mask by position (queries at the end of
    a longer key row, three key pads), against ``full_attention``."""
    q, k, v, _ = _qkv(2, 12, 40, 4, 2, 16, seed=3)
    kpos = np.stack([np.arange(40), np.r_[np.arange(37), [-1] * 3]])
    qpos = kpos[:, 25:37].copy()
    kpos, qpos = kpos.astype(np.int32), qpos.astype(np.int32)
    want = jlayers.full_attention(*_j(q, k, v, qpos, kpos), causal=True)
    tq, tk, tv, tqp, tkp = _t(q, k, v, qpos, kpos)
    got = tref.flash_attention_ref(tq, tk, tv, True, 0, tqp, tkp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_matches_jax_chunked_attention():
    """Against the reference's online-softmax ``chunked_attention`` (its
    path past 8,192 keys), in chunks of 16, on image ties with pads."""
    q, k, v, _ = _qkv(2, 64, 64, 4, 2, 16, seed=4)
    pos = _positions("image_pads", 2, 64)
    want = jlayers.chunked_attention(*_j(q, k, v, pos, pos), chunk=16)
    tq, tk, tv, tpos = _t(q, k, v, pos)
    got = tref.flash_attention_ref(tq, tk, tv, True, 0, tpos, tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_matches_jax_local_attention():
    """Against the reference's banded ``local_attention`` (its windowed
    path where S is a multiple of the window), window 16 over S 64: packed
    rows whose second sequence starts 1,000 on (out of every first-
    sequence key's window) and pads at −1; the rows that see a key."""
    q, k, v, _ = _qkv(2, 64, 64, 4, 2, 16, seed=5)
    pos = np.stack([_packed_row(64, 21, 5, gap=1000),
                    _packed_row(64, 40, 0, gap=1000)])
    want = jlayers.local_attention(*_j(q, k, v, pos, pos), window=16)
    tq, tk, tv, tpos = _t(q, k, v, pos)
    got = tref.flash_attention_ref(tq, tk, tv, True, 16, tpos, tpos)
    real = pos >= 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL)


def _jax_grads(q, k, v, do, pos, causal, window):
    def loss(q, k, v):
        out = jlayers.full_attention(q, k, v, pos, pos, window=window,
                                     causal=causal)
        return jnp.sum(out * do)
    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))


def _close_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, atol=ATOL + ATOL * np.abs(w).max())


@pytest.mark.parametrize("name", ["image_pads_causal", "packed_pads_window"])
def test_gradients_match_jax(name):
    """Autograd through the port's op and the plain backward (from the
    f32 output) against ``jax.grad`` of ``full_attention``: a pad row
    passes its uniform weights to dV alone."""
    kind, b, s, hq, hkv, d, causal, window = FULL_CASES[name]
    q, k, v, do = _qkv(b, s, s, hq, hkv, d, seed=6)
    pos = _positions(kind, b, s)
    want = _jax_grads(q, k, v, do, pos, causal, window)
    tq, tk, tv, tdo, tpos = _t(q, k, v, do, pos)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tops.flash_attention(*leaves, causal=causal, window=window,
                               q_pos=tpos, k_pos=tpos)
    got = torch.autograd.grad(out, leaves, tdo)
    _close_grads([g.numpy() for g in got], want)
    plain = tref.flash_attention_bwd_ref(tq, tk, tv, out.detach(), tdo,
                                         causal, window, tpos, tpos)
    _close_grads([g.numpy() for g in plain], want)
    pads = torch.from_numpy(pos < 0)
    if bool(pads.any()):
        # the pads' queries get no gradient (their scores are masked)
        assert float(got[0][pads].abs().max()) == 0.0


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_index_positions_give_the_index_path(causal, window):
    """Positions equal to the index mask exactly as the index masks:
    output and gradients equal bitwise."""
    q, k, v, do = _qkv(2, 33, 33, 4, 2, 16, seed=7)
    tq, tk, tv, tdo = _t(q, k, v, do)
    idx = torch.arange(33, dtype=torch.int32)[None].repeat(2, 1)
    outs, grads = [], []
    for pos in (None, idx):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = tops.flash_attention(*leaves, causal=causal, window=window,
                                   q_pos=pos, k_pos=pos)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, leaves, tdo))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_row_that_sees_no_key_gets_the_mean_of_v():
    """A pad query (position −1) sees no key: the reference's finite
    mask gives it uniform weights, the mean of V over every key."""
    q, k, v, _ = _qkv(1, 10, 10, 2, 2, 16, seed=8)
    pos = np.r_[np.arange(8), [-1, -1]][None].astype(np.int32)
    tq, tk, tv, tpos = _t(q, k, v, pos)
    got = tref.flash_attention_ref(tq, tk, tv, True, 0, tpos, tpos)
    mean = tv.mean(dim=1)                                   # (1, Hkv, D)
    torch.testing.assert_close(got[:, 8], mean, atol=ATOL, rtol=0)
    torch.testing.assert_close(got[:, 9], mean, atol=ATOL, rtol=0)


def test_position_arguments_are_checked():
    """``q_pos`` and ``k_pos`` come together; without positions a causal
    mask between two lengths still raises, with them it is taken."""
    q, k, v, _ = _qkv(1, 4, 6, 2, 2, 16, seed=9)
    tq, tk, tv = _t(q, k, v)
    pos = torch.arange(6, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="together"):
        tref.flash_attention_ref(tq, tk, tv, True, 0, pos[:, :4], None)
    with pytest.raises(ValueError, match="causal=False"):
        tref.flash_attention_ref(tq, tk, tv, True, 0)
    out = tref.flash_attention_ref(tq, tk, tv, True, 0, pos[:, 2:], pos)
    assert out.shape == tq.shape
