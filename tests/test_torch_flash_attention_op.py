"""``flash_attention`` as the operators ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd`` (no JAX: the parent's CPU route,
autograd through ``kernels/ref.py::flash_attention_ref``, is the
reference here).

* ``torch.export`` traces a call as one node, none of the plain
  version's products in the graph; on ``meta`` the fake implementations
  give the shapes, forward and backward.
* The forward and the gradients equal the parent's CPU route, autograd
  through the plain version, **bitwise**, float32 and bfloat16: the
  backward operator's CPU implementation forms the gradient as autograd
  does (``ref.flash_attention_vjp_ref``).  Under the flag ``bf16_attn_p``
  too, bfloat16, where the forward takes P in V's dtype and autograd
  differentiates that cast (and the gradients move with the flag).
* Training under each remat policy calls the forward once a layer, once
  more where the block is recomputed, and the backward once a layer, as
  the kernels launch on the card (``chip_smoke.py`` phase 7: 24 + 24 +
  24 a step under "full"); the loss and gradients are the same under
  every policy, bitwise.
* A tensor on a device with no kernel path raises; there is no fallback.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, flags
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops, ref
from repro_torch.models import api, transformer
from repro_torch.models.params import init_params
from repro_torch.roofline.collect import StepCounter

torch.set_num_threads(1)

# (b, sq, skv, hq, hkv, d, causal, window, positions)
CASES = {"causal_gqa": (2, 40, 40, 4, 2, 16, True, 0, False),
         "window": (2, 40, 40, 4, 2, 16, True, 8, False),
         "full": (2, 40, 40, 4, 4, 16, False, 0, False),
         "cross": (2, 40, 24, 4, 4, 16, False, 0, False),
         "positions_with_pads": (2, 40, 40, 4, 2, 16, True, 0, True)}


def _inputs(dtype, b, sq, skv, hq, hkv, d, positions, device="cpu"):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(device=device,
                                                     dtype=dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    do = torch.randn((b, sq, hq, d), generator=gen).to(device=device,
                                                        dtype=dtype)
    qp = kp = None
    if positions:
        qp = torch.arange(sq, dtype=torch.int32).repeat(b, 1)
        qp[0, :5] = -1                                  # left pads
        kp = qp.clone()
        qp, kp = qp.to(device), kp.to(device)
    return q, k, v, do, qp, kp


def test_export_traces_one_node():
    q, k, v, _, _, _ = _inputs(torch.float32, 1, 32, 32, 4, 2, 16, False)
    prog = torch.export.export(_Attend(), (q, k, v))
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.flash_attention.default") == 1
    assert not any("bmm" in t or "einsum" in t or "softmax" in t
                   for t in targets), targets
    assert torch.equal(prog.module()(q, k, v), _Attend()(q, k, v))


class _Attend(torch.nn.Module):
    def forward(self, q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_equal_autograd_through_the_plain_version(case, dtype):
    b, sq, skv, hq, hkv, d, causal, window, positions = CASES[case]
    q, k, v, do, qp, kp = _inputs(dtype, b, sq, skv, hq, hkv, d, positions)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_pos=qp, k_pos=kp)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_pos=qp, k_pos=kp)
    assert torch.equal(out, want)
    got = torch.autograd.grad(out, (q, k, v), do)
    exp = torch.autograd.grad(want, (q, k, v), do)
    for name, a, e in zip("qkv", got, exp):
        assert a.dtype == dtype and torch.equal(a, e), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_under_bf16_attn_p_equal_autograd(case):
    b, sq, skv, hq, hkv, d, causal, window, positions = CASES[case]
    q, k, v, do, qp, kp = _inputs(torch.bfloat16, b, sq, skv, hq, hkv, d,
                                  positions)
    for t in (q, k, v):
        t.requires_grad_(True)
    kw = dict(causal=causal, window=window, q_pos=qp, k_pos=kp)
    off = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v),
                              do)
    try:
        flags.set_flags(bf16_attn_p=True)
        out = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), do)
        exp = torch.autograd.grad(want, (q, k, v), do)
    finally:
        flags.set_flags(bf16_attn_p=False)
    assert torch.equal(out, want)
    for name, a, e in zip("qkv", got, exp):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e), name
    assert not torch.equal(got[2], off[2])


def test_meta_shapes_forward_and_backward():
    q, k, v, do, _, _ = _inputs(torch.bfloat16, 2, 40, 24, 8, 2, 64, False,
                                device="meta")
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    (dq,) = torch.autograd.grad(out, (q,), do)
    assert dq.shape == q.shape and dq.dtype == q.dtype
    _, lse = torch.ops.repro_torch.flash_attention(q, k, v, None, None,
                                                   False, 0)
    assert lse.shape == (2, 8, 40) and lse.dtype == torch.float32


def test_other_devices_raise():
    class OnXpu:
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="no kernel path"):
        ops._on_card(OnXpu())
    q, k, v, _, _, _ = _inputs(torch.float32, 1, 8, 8, 2, 2, 16, False)
    with pytest.raises(ValueError, match="no kernel path"):
        ops.flash_attention(OnXpu(), k, v)


def test_training_calls_under_each_remat_policy():
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, "cpu", trainable=True)
    batch = api.synthetic_inputs(cfg, 2, 32, gen, device="cpu")
    base = None
    n = cfg.n_layers
    for policy in transformer.REMAT_POLICIES:
        counter = StepCounter()
        with counter:
            loss, _ = transformer.forward_train(cfg, params, batch,
                                                remat=policy)
            grads = torch.autograd.grad(loss, leaves(params.tree()))
        recomputed = 0 if policy == "none" else n
        assert counter.launches["flash_attention"] == n + recomputed, policy
        assert counter.launches["flash_attention_bwd"] == n, policy
        if base is None:
            base = (loss, grads)
        assert torch.equal(loss, base[0])
        assert all(torch.equal(a, b) for a, b in zip(grads, base[1]))
