"""The remat policies of the training path, on the CPU: "dots" and
"dots_no_batch" (``torch.utils.checkpoint`` with a selective-checkpoint
policy that keeps the outputs of the products) against the reference's
``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``.

The internlm2, falcon-mamba (mamba1) and zamba2 (hybrid) smoke configs
and phi3.5-moe's (expert banks by ``bmm``) in float32, the JAX package's
weights carried across: ``forward_train``'s loss (atol 1e-5) and every
gradient (rtol 1e-4, atol 1e-6, the training test's limits) against
``jax.value_and_grad`` under the same policy.  A policy changes what is
kept, not what is computed: the port's four policies give the same loss
and gradients bit for bit, and a count of the products the backward runs
shows what each keeps (every 2-D product recomputed under "full", none
under "dots_no_batch"; the batched ones recomputed under "dots_no_batch",
none under "dots"; the attention operator's forward under all three).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy

torch.set_num_threads(1)

# arch: the sequence length of its batch (falcon-mamba: two of the
# reference's scan chunks of 128; zamba2: two SSD chunks of 256)
SEQ = {"internlm2-1.8b": 64, "falcon-mamba-7b": 256, "zamba2-2.7b": 512,
       "phi3.5-moe-42b-a6.6b": 64}


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in SEQ:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
        out[arch] = (jcfg, tcfg, jinit(jcfg, jax.random.key(0)))
    return out, jsyn.token_stream(20_000, 320, seed=1)


def _carry(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             trainable=True)


def _batch(tokens, arch, seed=4):
    batch = next(jsyn.lm_batches(tokens, 1, SEQ[arch], seed=seed))
    return batch, {k: torch.from_numpy(np.asarray(v))
                   for k, v in batch.items()}


def _loss_and_grads(tcfg, params, tb, remat):
    loss, _ = ttr.forward_train(tcfg, params, tb, remat=remat)
    return loss, torch.autograd.grad(loss, leaves(params.tree()))


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
@pytest.mark.parametrize("arch", list(SEQ))
def test_dots_policies_match_jax(setups, arch, policy):
    """Loss and every gradient under "dots" and "dots_no_batch" against
    ``jax.value_and_grad`` of the reference's ``forward_train`` under the
    same policy."""
    cfgs, tokens = setups
    jcfg, tcfg, jp = cfgs[arch]
    batch, tb = _batch(tokens, arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat=policy),
        has_aux=True))(jp)
    loss, grads = _loss_and_grads(tcfg, _carry(jp), tb, policy)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, jgrads))]
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_policies_change_what_is_kept_not_the_result(setups, arch):
    """The four policies give the same loss and gradients bit for bit
    (a recomputed block repeats the same arithmetic on the CPU)."""
    cfgs, tokens = setups
    _, tcfg, jp = cfgs[arch]
    _, tb = _batch(tokens, arch, seed=5)
    params = _carry(jp)
    base_loss, base = _loss_and_grads(tcfg, params, tb, "none")
    for policy in ttr.REMAT_POLICIES[1:]:
        loss, grads = _loss_and_grads(tcfg, params, tb, policy)
        assert torch.equal(loss, base_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), policy


class _Products(TorchDispatchMode):
    """Counts the products, and the attention operator's forward calls,
    dispatched while it is active."""

    NAMES = ("mm", "addmm", "bmm", "baddbmm", "flash_attention")

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(self.NAMES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(tcfg, params, tb, remat):
    loss, _ = ttr.forward_train(tcfg, params, tb, remat=remat)
    with _Products() as mode:
        torch.autograd.grad(loss, leaves(params.tree()))
    return mode.counts


def test_what_each_policy_recomputes(setups):
    """The products the backward runs, on phi3.5-moe (its expert banks are
    batched products): "full" recomputes every product of each block;
    "dots_no_batch" keeps the 2-D ones (every projection) and recomputes
    the batched ones; "dots" keeps both, so its backward runs the products
    "none" runs.  The attention is one operator on either device
    (``repro_torch::flash_attention``; on the CPU its plain version runs
    inside it), holds no product to keep, and runs again once a layer
    under every policy but "none", as the kernel does on the card."""
    cfgs, tokens = setups
    arch = "phi3.5-moe-42b-a6.6b"
    _, tcfg, jp = cfgs[arch]
    _, tb = _batch(tokens, arch, seed=6)
    params = _carry(jp)
    n = {p: _backward_products(tcfg, params, tb, p)
         for p in ttr.REMAT_POLICIES}
    flat = {p: (c["mm"] + c["addmm"], c["bmm"] + c["baddbmm"])
            for p, c in n.items()}
    assert flat["dots"] == flat["none"]
    assert flat["dots_no_batch"][0] == flat["none"][0]
    assert flat["dots_no_batch"][1] > flat["none"][1]
    assert flat["full"][0] > flat["none"][0]
    assert flat["full"][1] == flat["dots_no_batch"][1]
    assert n["none"]["flash_attention"] == 0
    for policy in ("full", "dots", "dots_no_batch"):
        assert n[policy]["flash_attention"] == tcfg.n_layers, policy


def test_policy_names_and_refusal(setups):
    """The reference's four names, and an unknown one raises."""
    from repro.models.transformer import REMAT_POLICIES as JPOLICIES
    assert set(ttr.REMAT_POLICIES) == set(JPOLICIES)
    cfgs, tokens = setups
    _, tcfg, jp = cfgs["internlm2-1.8b"]
    _, tb = _batch(tokens, "internlm2-1.8b")
    with pytest.raises(ValueError, match="unknown remat policy"):
        ttr.forward_train(tcfg, _carry(jp), tb, remat="everything")
