"""Port parity: training the mamba1 trunk (falcon-mamba-7b), the hybrid
trunk (zamba2-2.7b) and the sliding-window trunk (gemma3-4b) against the
JAX package, on the CPU.

Each smoke config in float32; the JAX package's own ``init_params``
weights carried across as trainable f32 masters (``params_from_numpy``);
batches from the two packages' Markov token streams, which are bitwise
equal.  ``forward_train``'s loss and every gradient against
``jax.value_and_grad`` of the reference's ``forward_train``: loss atol
1e-5, gradients rtol 1e-4 and atol 1e-6 (the training test's limits; the
reference scans mamba1 associatively in chunks of 128 and the port in
order, readings stay below 3e-8 of excess over rtol 1e-4).  S 256 for
falcon-mamba is two of the reference's scan chunks, S 512 for zamba2 two
of its SSD chunks of 256; gemma3's S 24 is three times its window of 8.
Then one AdamW step against the JAX step: loss and grad norm rtol 1e-5,
weights atol 1e-5 (as the training test's three steps) except where the
gradient is below 100 eps = 1e-6 in magnitude.  There AdamW's first step
moves a weight by lr g / (|g| + eps), which a gradient difference within
the gradient limit's atol of 1e-6 can change by up to the whole step, so
those weights are held within 2 lr, the most two first steps can differ
(a zamba2 SSD weight with gradients 9.1e-8 and 1.01e-7 moved 6.31e-4 and
6.56e-4).  Last, the launcher with ``--device cpu``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.models import transformer as jtr
from repro.models.params import init_params as jinit
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.core.tree import leaves
from repro_torch.models import transformer as ttr
from repro_torch.models.params import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

# arch: the sequence length of its parity batch
SEQ = {"falcon-mamba-7b": 256, "zamba2-2.7b": 512, "gemma3-4b": 24}


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


def _np_leaves(tree):
    return [np.asarray(x) for x in leaves(jax.tree.map(np.asarray, tree))]


def _paths(tree, prefix=""):
    """The leaves' paths, in the order of ``leaves``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def check_forward_train(jcfg, tcfg, jp, batch, remat, jremat=None):
    """``forward_train``'s loss and every gradient under ``remat`` against
    ``jax.value_and_grad`` of the reference's under ``jremat`` (the same
    policy unless given); returns the port's leaf paths."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat=jremat or remat),
        has_aux=True))(jp)
    params = _carry(jp)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = ttr.forward_train(tcfg, params, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves(params.tree()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    want = _np_leaves(jgrads)
    names = _paths(params.tree())
    assert len(grads) == len(want) == len(names)
    for name, a, b in zip(names, grads, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert np.isfinite(a.numpy()).all()
    return names, grads


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", list(SEQ))
def test_forward_train_matches_jax(setups, arch, remat):
    """Loss and every gradient of the three trunks, with and without remat;
    the SSM layers' own weights (the scan's A, the skip, the conv) among
    them, and nonzero."""
    cfgs, tokens = setups
    jcfg, tcfg, jp = cfgs[arch]
    batch = next(jsyn.lm_batches(tokens, 1, SEQ[arch], seed=4))
    names, grads = check_forward_train(jcfg, tcfg, jp, batch, remat)
    key = {"falcon-mamba-7b": "blocks/mamba/a_log",
           "zamba2-2.7b": "groups/mamba/a_log",
           "gemma3-4b": "groups/global/attn/wq"}[arch]
    assert key in names
    assert float(grads[names.index(key)].abs().max()) > 0


@pytest.mark.parametrize("arch", list(SEQ))
def test_adamw_step_matches_jax(setups, arch):
    """One ``make_train_step`` step (AdamW lr 1e-3, remat full) on the same
    batch as the JAX step: loss and grad norm, then every weight."""
    cfgs, tokens = setups
    jcfg, tcfg, jp = cfgs[arch]
    lr, eps = 1e-3, topt.AdamWConfig().eps
    batch = next(jsyn.lm_batches(tokens, 2, 32, seed=9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(
        lambda p: jtr.forward_train(jcfg, p, jb, remat="full")[0]))(jp)
    jstep = jax.jit(jmake_train_step(jcfg, remat="full",
                                     opt=jopt.AdamWConfig(lr=lr)))
    jparams, _, jm = jstep(jp, jopt.adamw_init(jp), jb)
    params = _carry(jp)
    tstep = make_train_step(tcfg, remat="full",
                            opt=topt.AdamWConfig(lr=lr))
    params, _, tm = tstep(params, topt.adamw_init(params), batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    for a, b, g in zip(leaves(params.tree()), _np_leaves(jparams),
                       _np_leaves(jgrads)):
        err = np.abs(a.detach().numpy() - b)
        near_eps = np.abs(g) < 100 * eps
        assert err[~near_eps].max(initial=0) <= 1e-5
        assert err[near_eps].max(initial=0) <= 2 * lr


@pytest.mark.parametrize("arch", list(SEQ))
def test_launcher_trains_each_trunk(arch, tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch <id> --device cpu`` (the
    smoke config) trains the mamba1, hybrid and sliding-window trunks and
    checkpoints, as the JAX launcher does."""
    from repro_torch.launch import train as launch
    out = tmp_path / "out.json"
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "32", "--remat", "full",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
        "--out", str(out)])
    launch.main()
    rec = json.loads(out.read_text())
    assert rec["arch"] == f"{arch}-smoke" and rec["steps"] == 2
    assert np.isfinite(rec["final"]) and np.isfinite(rec["held_out"]).all()
    assert "device=cpu" in capsys.readouterr().out
