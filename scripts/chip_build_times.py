"""Wall seconds of each kernel source's ``nvcc``, on a machine with the
CUDA toolkit, with and without ``--split-compile=0`` (nvcc's optimizer on
every core):

    python scripts/chip_build_times.py [--rounds alone,together]

``alone`` builds each source by itself, one after another; ``together``
starts one ``nvcc`` per source, all at once, as ``build_all`` does.  Each
round builds every source with ``repro_torch.kernels.build``'s flags and
then with ``--split-compile=0`` added.  Each source's ptxas report of
every kernel (registers, stack and spills) is compared between the two:
it must be the same for the sources of ``build.SPLIT_COMPILE``, and for
the others the line says whether it is.  Prints one line a build and,
last, one JSON line of the readings.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build  # noqa: E402

SPLIT = "--split-compile=0"
REPORT = re.compile(r"Compiling entry function '_ZN\w*?_GLOBAL__N__[0-9a-f]+_"
                    r"(\w+)'|(Used \d+ registers.*)|(\d+ bytes stack frame.*)")


def run(mode: str, split: bool) -> dict:
    """Build every source (``mode``: alone or together); returns, by
    source, its seconds and its ptxas report."""
    got = {}
    with tempfile.TemporaryDirectory() as d:
        def start(name):
            cmd = [build.nvcc(), *build.NVCC_FLAGS, *([SPLIT] if split
                                                      else []),
                   "-o", str(Path(d) / f"{name}.so"),
                   str(build.CSRC / build.SOURCES[name])]
            return time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

        def finish(name, t0, proc):
            stdout, stderr = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n"
                                 f"{stdout}{stderr}")
            got[name] = (seconds,
                         ["".join(m) for m in REPORT.findall(stderr)])

        if mode == "alone":
            for name in build.SOURCES:
                finish(name, *start(name))
        else:
            jobs = {name: start(name) for name in build.SOURCES}
            while jobs:       # each source's seconds end when its nvcc does
                for name, (t0, proc) in list(jobs.items()):
                    if proc.poll() is not None:
                        finish(name, t0, proc)
                        del jobs[name]
                time.sleep(0.05)
    for name, (seconds, report) in got.items():
        print(f"{mode:8s} split={split!s:5s} {name:16s} {seconds:7.1f} s")
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", default="together",
                    help="comma-separated: alone, together")
    out = {}
    for mode in ap.parse_args().rounds.split(","):
        plain, split = run(mode, False), run(mode, True)
        out[mode] = {}
        for name in build.SOURCES:
            same = plain[name][1] == split[name][1]
            print(f"{mode:8s} {name:16s} ptxas report"
                  f" {'the same' if same else 'differs'} with {SPLIT}")
            if name in build.SPLIT_COMPILE and not same:
                raise SystemExit(f"{name}: the ptxas report differs with"
                                 f" {SPLIT}")
            out[mode][name] = {"seconds": plain[name][0],
                               "split_seconds": split[name][0],
                               "report_same": same}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
