"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither ``jax`` nor the
JAX package ``repro``, the examples run with ``--device cpu``, and no
entry point quietly runs on the CPU when no GPU is present.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve.kvcache import alloc_decode_cache
from repro_torch.serve.server import ContinuousBatchServer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


EXAMPLES = ("torch_quickstart.py", "torch_eon_tuner_kws.py",
            "torch_train_lm.py")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "examples" / name for name in EXAMPLES] + \
        [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, "port modules import the JAX side:\n" + "\n".join(bad)


@pytest.mark.parametrize("name,expect,extra", [
    ("torch_quickstart.py", "deploy artifact: ", ()),
    ("torch_eon_tuner_kws.py", "pass the nano33ble RAM/flash/latency", ()),
    # a few steps of a small LM, its files in the test's directory
    ("torch_train_lm.py", '"final_loss"',
     ("--steps", "3", "--d-model", "128", "--layers", "2", "--vocab", "512",
      "--batch", "2", "--seq", "16", "--micro", "2"))])
def test_examples_run_on_the_cpu(name, expect, extra, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if name == "torch_train_lm.py":
        extra += ("--ckpt-dir", str(tmp_path / "ck"),
                  "--out", str(tmp_path / "out.json"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           "--device", "cpu", *extra], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout


def test_no_gpu_no_default_device(monkeypatch):
    """Without a GPU, every entry point raises unless the caller passes
    device="cpu" itself."""
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchServer(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        alloc_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": params["embed"].numpy()})
    ContinuousBatchServer(cfg, params, device="cpu")


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repo exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
