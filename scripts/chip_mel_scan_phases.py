"""The mel frontend's and the selective scan's phases of one tree's
``chip_smoke.py``, on the card: the build of the two kernels
(``mel_frontend``, ``mamba_scan``) with ptxas' report, phase 2's mel and
scan rows (each kernel against its plain version, timed against the
bound, the mel rows against the rfft chain), phase 6's KWS Impulse at
full width with its profile (clips/s, batch-1 latency, the mel kernel's
ms a call) and phase 8's falcon-mamba-7b serving at full width with its
decode and chunk step profile.  Each phase is the tree's own code, so two
trees run in turns in one call compare like with like on one card:

    for t in build/parent . . build/parent; do
        python scripts/chip_mel_scan_phases.py "$t"; done

Prints the card's name and power limit and, last, one JSON line of the
rows, the metrics and the profiles.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from chip_int8_phases import load_smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    tree = Path(ap.parse_args().tree).resolve()
    cs = load_smoke(tree)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the mel and scan phases need one GPU")
    port = cs.load_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = port.build.build_all(["mel_frontend", "mamba_scan"])
    for name, log in logs.items():
        print(f"  {name}:")
        for line in log.splitlines():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line:
                print("   " + line.strip()[:170])
    print(f"  build {time.perf_counter() - t0:.1f} s")
    clips, _ = cs.keyword_clips(port, cs.KWS_CLIPS, 12, 16_000, seed=0)

    print("phase 2: mel_frontend and mamba_scan against their plain versions")
    mel_rows = cs.check_mel_frontend(port, clips)
    scan_rows = cs.check_mamba_scan(port)
    print("phase 6: full-width KWS Impulse, DS-CNN on MFE, f32 and PTQ int8")
    launches_kws, kws_metrics, kws_prof = cs.kws_impulse(port, clips)
    print("phase 8: full-width mamba1 serving, falcon-mamba-7b bf16")
    torch.cuda.empty_cache()
    mcfg = cs.mamba_config(port)
    mparams, launches_ssm, metrics_ssm = cs.serve_mamba_full(port, mcfg)
    ssm_prof = cs.profile_steps(port, mcfg, mparams)
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"tree": str(tree), "gpu": gpu, "mel_frontend": mel_rows,
                      "mamba_scan": scan_rows, "launches_kws": launches_kws,
                      "kws_impulse": kws_metrics, "profile_kws": kws_prof,
                      "launches_ssm": launches_ssm,
                      "mamba1_serving": metrics_ssm,
                      "profile_ssm": ssm_prof}))


if __name__ == "__main__":
    main()
