"""Port parity: the EON compiler (``core/eon_compiler.py``) against the JAX
package, on the CPU.

- ``compile_impulse``, float and int8: the same name as the JAX artifact,
  saved and loaded through a file, and the rehydrated program's logits
  within ``atol=1e-4`` of the JAX artifact's on the same carried weights
  (the limit of ``tests/test_core.py::test_eon_compiler_roundtrip``).
- Exporting an Impulse before any eager call leaves the eager path intact:
  the DSP block's cached tables are built eagerly first.
- ``compile_serve_decode``, contiguous and paged, float and int8, for
  internlm2 and falcon-mamba: the name and every resource key the JAX
  package reports (KV bytes of both precisions, pool block bytes and
  count, parameter bytes) equal; the rehydrated step **bitwise** equal to
  the eager step, logits and cache, over steps with an idle slot; and the
  program reads nothing back to the host (no ``item``/``nonzero``), which
  a CUDA graph capture would refuse.
- ``compile_fn``'s report and ``measure_dispatch_overhead``.

The JAX package cannot serialize a falcon-mamba decode artifact: its
``SSMState`` is not registered with ``jax.export`` (ROADMAP.md queue 3).
This module registers it, from the outside, before the JAX side compiles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.core import blocks as jcb
from repro.core import eon_compiler as jeon
from repro.core import quantize as jq
from repro.core.impulse import Impulse as JImpulse
from repro.models.params import init_params as jinit
from repro.models.ssm import SSMState as JSSMState
from repro_torch import configs as tconfigs
from repro_torch.core import blocks as tcb
from repro_torch.core import eon_compiler as teon
from repro_torch.core import quantize as tq
from repro_torch.core.impulse import Impulse as TImpulse
from repro_torch.data import synthetic as tsyn
from repro_torch.dsp import blocks as tdsp
from repro_torch.models.params import kws_params_from_numpy, params_from_numpy
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import serve_step as tss

torch.set_num_threads(1)
jax.export.register_namedtuple_serialization(
    JSSMState, serialized_name="repro.models.ssm.SSMState")

N_SAMPLES = 4000
IMPULSE = (("mfcc", {"n_mels": 32, "n_coeffs": 10}),
           ("conv1d-stack", {"n_blocks": 2, "ch_first": 16, "ch_last": 32,
                             "n_classes": 3}))
# host reads a CUDA graph cannot capture
HOST_READS = ("aten.item", "aten._local_scalar_dense", "aten.nonzero")


def _impulses():
    (dk, dkw), (lk, lkw) = IMPULSE
    jimp = JImpulse(jcb.make_dsp_block(dk, **dkw),
                    jcb.make_learn_block(lk, **lkw), input_shape=N_SAMPLES)
    jimp.init(jax.random.key(0))
    timp = TImpulse(tcb.make_dsp_block(dk, **dkw),
                    tcb.make_learn_block(lk, **lkw), input_shape=N_SAMPLES,
                    device="cpu")
    timp.params = kws_params_from_numpy(jax.tree.map(np.asarray,
                                                     jimp.params), "cpu")
    xs = np.stack([s.data for s in tsyn.keyword_audio(
        n_per_class=2, n_classes=3, n_samples=N_SAMPLES, seed=1)])
    return jimp, timp, xs


def _clear_dsp_tables():
    for fn in (tdsp._dft_tables, tdsp._mel_table, tdsp._dct_table):
        fn.cache_clear()


@pytest.mark.parametrize("int8", [False, True])
def test_compile_impulse_matches_jax(tmp_path, int8):
    jimp, timp, xs = _impulses()
    if int8:
        jimp.quantize(xs[:4])
        timp.quantize(xs[:4])
    jart = jeon.compile_impulse(jimp, batch_size=1, int8=int8)
    tart = teon.compile_impulse(timp, batch_size=1, int8=int8)
    assert tart.name == jart.name
    assert tart.artifact_bytes > 0
    assert tart.memory["code_bytes"] == tart.artifact_bytes
    assert tart.memory["argument_bytes"] == N_SAMPLES * 4
    assert tart.memory["temp_bytes"] == 0
    tart.save(tmp_path / "deploy.bin")
    loaded = teon.CompiledArtifact.load(tmp_path / "deploy.bin")
    assert loaded.serialized == tart.serialized
    assert loaded.name == tart.name
    jfn, tfn = jart.rehydrate(), loaded.rehydrate()
    for x in xs[:3]:
        got = tfn(torch.from_numpy(x[None])).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x[None]))),
                                   atol=1e-4)
        eager = (timp.logits_int8 if int8 else timp.logits)(x[None])
        np.testing.assert_array_equal(got, eager.numpy())


def test_export_before_any_eager_call_keeps_the_eager_path():
    """The DSP tables are cached per device at first use; a first use
    inside ``torch.export`` would cache traced tensors.  Exported first,
    the Impulse still runs eagerly, and both agree bitwise."""
    _, timp, xs = _impulses()
    _clear_dsp_tables()
    fn = teon.compile_impulse(timp, batch_size=2).rehydrate()
    x = torch.from_numpy(xs[:2])
    np.testing.assert_array_equal(fn(x).numpy(), timp.logits(x).numpy())
    assert not any(type(t).__name__ == "FakeTensor"
                   for t in tdsp._dft_tables(200, 512, torch.device("cpu")))


# (arch, precision, paged)
DECODE_CASES = [("internlm2-1.8b", "float", False),
                ("internlm2-1.8b", "int8", False),
                ("internlm2-1.8b", "float", True),
                ("internlm2-1.8b", "int8", True),
                ("falcon-mamba-7b", "float", False),
                ("falcon-mamba-7b", "int8", True)]
SLOTS, CAPACITY, POOL, BS = 2, 16, 4, 8


def _decode_pair(arch, precision, paged):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    jp = jinit(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jpol = jq.INT8 if precision == "int8" else None
    tpol = tq.INT8 if precision == "int8" else None
    if jpol is not None:
        jp = jq.quantize_model_params(jp, jpol)
        tp = tq.quantize_model_params(tp, tpol)
    kw = dict(pool_blocks=POOL, block_size=BS) if paged else {}
    jart = jeon.compile_serve_decode(jcfg, jp, slots=SLOTS,
                                     capacity=CAPACITY, policy=jpol, **kw)
    tart = teon.compile_serve_decode(tcfg, tp, slots=SLOTS,
                                     capacity=CAPACITY, policy=tpol, **kw)
    return tcfg, tp, tpol, jart, tart


@pytest.mark.parametrize("arch,precision,paged", DECODE_CASES,
                         ids=[f"{a}-{p}-{'paged' if g else 'slots'}"
                              for a, p, g in DECODE_CASES])
def test_compile_serve_decode_matches_jax(arch, precision, paged):
    tcfg, tp, pol, jart, tart = _decode_pair(arch, precision, paged)
    assert tart.name == jart.name
    keys = ("kv_cache_bytes", "kv_cache_bytes_float", "param_bytes")
    if paged:
        keys += ("kv_block_bytes", "kv_pool_blocks")
    for key in keys:
        assert tart.memory[key] == jart.memory[key], key
    assert tart.memory["code_bytes"] == tart.artifact_bytes
    # the weights are an input, not baked in: the program keeps no weight
    assert tart.memory["argument_bytes"] > tart.memory["param_bytes"]
    program = tart.program()
    baked = list(program.state_dict.values()) + list(
        program.constants.values())
    assert all(t.numel() <= 1 for t in baked), [t.shape for t in baked]
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert not any(t.startswith(HOST_READS) for t in targets), targets

    fn = tart.rehydrate()
    if paged:
        eager = tss.make_paged_decode_step(tcfg, pol)
        caches = [tkv.alloc_paged_cache(tcfg, SLOTS, CAPACITY, POOL, "cpu",
                                        pol, BS) for _ in range(2)]
        extra = (torch.tensor([[2, 0], [1, 3]], dtype=torch.int32),)
    else:
        eager = tss.make_slot_decode_step(tcfg, pol)
        caches = [tkv.alloc_decode_cache(tcfg, SLOTS, CAPACITY, "cpu", pol)
                  for _ in range(2)]
        extra = ()
    gen = torch.Generator().manual_seed(1)
    for t in range(4):
        tok = torch.randint(0, tcfg.vocab_size, (SLOTS,), generator=gen,
                            dtype=torch.int32)
        pos = torch.tensor([t, t + 5], dtype=torch.int32)
        kvl = torch.tensor([t + 1, 0 if t == 2 else t + 6],
                           dtype=torch.int32)
        got = fn(tp, caches[0], tok, pos, kvl, *extra)
        want = eager(tp, caches[1], tok, pos, kvl, *extra)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip(pytree.tree_leaves(caches[0]),
                        pytree.tree_leaves(caches[1])):
            assert torch.equal(a, b)


def test_compile_fn_report():
    """argument and output bytes exact, the matmul's flops, no pool on the
    CPU; the artifact pickles its input specs as meta tensors."""
    a = torch.randn(8, 16)
    b = torch.randn(16, 4)
    art = teon.compile_fn(lambda x, y: (x @ y).relu(), a, b, name="mm")
    assert art.name == "mm"
    assert art.memory == {"argument_bytes": (8 * 16 + 16 * 4) * 4,
                          "output_bytes": 8 * 4 * 4, "temp_bytes": 0,
                          "code_bytes": art.artifact_bytes}
    assert art.flops == 2 * 8 * 16 * 4
    assert [t.device.type for t in art.input_specs] == ["meta", "meta"]
    assert torch.equal(art.rehydrate()(a, b), (a @ b).relu())
    assert teon.normalize_cost_analysis([{"flops": 3.0}]) == {"flops": 3.0}
    assert teon.normalize_cost_analysis(None) == {}


def test_measure_dispatch_overhead():
    x = torch.randn(4, 32)
    w = torch.randn(32, 32)
    out = teon.measure_dispatch_overhead(lambda a: (a @ w).tanh() @ w, x,
                                         iters=3)
    assert set(out) == {"eager_us", "aot_us", "speedup"}
    assert out["eager_us"] > 0 and out["aot_us"] > 0
    assert out["speedup"] == pytest.approx(out["eager_us"] / out["aot_us"])
