"""The EON compiler on the card: a deployed step captured as a CUDA graph
and replayed.  Skipped without a GPU (marker ``cuda``); run there with

    python -m pytest -q -m cuda tests/test_torch_eon_cuda.py

- The engines served from the decode artifact give the eager engines'
  tokens (the small float32 internlm2 config the kernels take, contiguous
  float and paged int8, and falcon-mamba's smoke config); the graph was
  captured at construction, and every decode step of the run is a replay:
  the wrappers count only the eager chunk steps, and the launches captured
  times the replays make up the eager run's decode launches exactly.
- The Impulse's artifact replays the mel kernel (one launch captured) and
  gives the eager logits.
- A step the graph cannot capture (a host read) raises; nothing falls
  back to the eager program (in a process of its own).

This file imports neither JAX nor the JAX package.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import blocks as tcb
from repro_torch.core import eon_compiler as eon
from repro_torch.core.impulse import Impulse
from repro_torch.data import synthetic
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import int8_matmul as tim
from repro_torch.kernels import mamba_scan as tms
from repro_torch.kernels import mel_frontend as tmf
from repro_torch.kernels import ops
from repro_torch.models.params import init_params
from repro_torch.serve.server import ContinuousBatchServer, PagedBatchServer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _reset():
    for mod in (tfd, tim, tmf, tms):
        mod.reset_launches()


def _config(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    if arch == "internlm2-1.8b":
        # the narrowest widths the attention kernels take (head dim 128)
        cfg = dataclasses.replace(cfg, d_model=256, n_heads=2, n_kv_heads=1)
    return cfg


def _serve(engine, cfg, params, **kw):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 9, 30)]
    srv = engine(cfg, params, slots=2, max_prompt=32, prefill_chunk=8,
                 max_new_tokens=6, device="cuda", **kw)
    reqs = srv.submit(prompts)
    _reset()
    metrics = srv.run()
    torch.cuda.synchronize()
    return [r.tokens for r in reqs], metrics, ops.launch_counts(), srv


CASES = [("internlm2-1.8b", ContinuousBatchServer, {}),
         ("internlm2-1.8b", PagedBatchServer,
          dict(precision="int8", block_size=8, pool_blocks=7)),
         ("falcon-mamba-7b", ContinuousBatchServer, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,engine,kw", CASES,
                         ids=["dense-continuous", "dense-paged-int8",
                              "mamba-continuous"])
def test_artifact_engine_replays_the_eager_tokens(cuda_device, arch, engine,
                                                  kw):
    cfg = _config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    etok, em, eager, _ = _serve(engine, cfg, params, **kw)
    atok, am, host, srv = _serve(engine, cfg, params, use_artifact=True,
                                 **kw)
    assert atok == etok
    step = srv.decode
    assert isinstance(step, eon.GraphStep)
    assert step.replays == am["decode_steps"] == em["decode_steps"]
    assert am["artifact_bytes"] == srv.artifact.artifact_bytes > 0
    assert srv.artifact.memory["temp_bytes"] > 0
    for name, n in eager.items():
        assert host[name] + step.captured_launches[name] * step.replays \
            == n, name
    assert sum(step.captured_launches.values()) > 0


@pytest.mark.cuda
def test_impulse_artifact_replays_the_mel_kernel(cuda_device):
    imp = Impulse(tcb.make_dsp_block("mfcc", n_mels=32, n_coeffs=10),
                  tcb.make_learn_block("conv1d-stack", n_blocks=2,
                                       ch_first=16, ch_last=64,
                                       n_classes=4),
                  input_shape=8000, device="cuda")
    imp.init(torch.Generator(device="cuda").manual_seed(1))
    clips = np.stack([s.data for s in synthetic.keyword_audio(
        n_per_class=2, n_classes=4, n_samples=8000, seed=2)])
    art = eon.compile_impulse(imp, batch_size=4)
    assert art.name == "mfcc+conv1d-stack" and art.device == "cuda"
    fn = art.rehydrate()
    xs = torch.from_numpy(clips).cuda()
    outs = [fn(xs[i:i + 4]).clone() for i in (0, 4, 0)]
    assert fn.captured_launches["mel_frontend"] == 1
    assert fn.replays == 2
    for i, out in zip((0, 4, 0), outs):
        torch.testing.assert_close(out, imp.logits(xs[i:i + 4]), rtol=0,
                                   atol=2.0 ** -17)


_FAILED_CAPTURE = """
import torch
from repro_torch.core import eon_compiler as eon

def fn(t):
    return t * t.sum().item()

x = torch.randn(16, device="cuda")
try:
    eon.compile_fn(fn, x)
except RuntimeError:
    print("compile_fn raised")
step = eon.GraphStep(torch.export.export(eon._Fn(fn), (x,)).module())
try:
    step(x)
except RuntimeError:
    print("GraphStep raised", step.graph is None, step.replays)
"""


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    """``item()`` reads the card from the host, which a capture refuses:
    ``compile_fn`` (whose capture sizes ``temp_bytes``) raises, and so does
    a ``GraphStep`` of the same program at its first call, instead of
    running eagerly.  In a process of its own: a failed capture leaves
    the CUDA generator in capture mode for the rest of the process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split("\n")[:2] == ["compile_fn raised",
                                           "GraphStep raised True 0"]
