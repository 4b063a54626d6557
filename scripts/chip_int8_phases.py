"""The int8 serving path's phases of one tree's ``chip_smoke.py``, on the
card: the build of the two kernels that path runs (``int8_matmul``,
``flash_decode``) with ptxas' report, phase 2's ``int8_matmul`` rows
(bitwise, timed against the bound and ``torch._int_mm``) and phase 5's
int8 paged serving of internlm2-1.8b at full width with its decode and
chunk step profile.  Each phase is the tree's own code, so two trees run
in turns in one call compare like with like on one card:

    for t in build/parent . . build/parent; do
        python scripts/chip_int8_phases.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
rows, the serving metrics and the step profiles.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import time
from pathlib import Path

import torch


def load_smoke(tree: Path):
    """The tree's ``chip_smoke.py`` as a module; its ``load_port`` imports
    the port from the tree's own ``src``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    tree = Path(ap.parse_args().tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the int8 phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["int8_matmul", "flash_decode"])
    for line in logs["int8_matmul"].splitlines():
        if "Compiling entry function" in line or "registers" in line \
                or "spill" in line:
            print("   " + line.strip()[:170])
    print(f"  build {time.perf_counter() - t0:.1f} s")

    print("phase 2: int8_matmul against its plain version")
    check = cs.check_int8_matmul
    # trees before the launch plan's rows take (ops, ref) alone
    rows = (check(port.ops, port.ref, port.im)
            if check.__code__.co_argcount == 3
            else check(port.ops, port.ref))
    print("phase 5: full-width int8 paged serving, internlm2-1.8b bf16")
    cfg = cs.full_config(port)
    params = port.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), "cuda")
    srv, launches, metrics = cs.serve_int8_paged(port, cfg, params)
    prof = cs.profile_steps(port, cfg, srv.params, port.quantize.INT8, True)
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "int8_matmul": rows,
                      "launches": launches, "int8_paged": metrics,
                      "profile": prof}))


if __name__ == "__main__":
    main()
