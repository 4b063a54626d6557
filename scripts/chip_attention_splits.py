"""The serving attention kernels at every split and row tile the launch
plan can choose, on the card: each kernel's wrapper alone (inputs laid
out beforehand), timed as ``chip_smoke.py`` times it, at phase 2's
serving cases (bf16, S 576: decode at fills {0, 1, 37, 576}, all four
slots full, int8 paged with blocks of 8, and every slot empty; the chunk
of 64 queries at 448 live entries, float and int8 paged with blocks of
64, and empty), each checked against its plain version.  The plan
(``kernels/flash_decode.py::_plan``) picks one of these; this shows what
the others cost:

    python scripts/chip_attention_splits.py

Prints one line a case, the card's name and power limit and, last, one
JSON line of the times in ms.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch
from chip_int8_phases import load_smoke


def main() -> None:
    cs = load_smoke(Path(__file__).resolve().parents[1])
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the attention kernels need one GPU")
    port = cs.load_port()
    fd, ops, ref = port.fd, port.ops, port.ref
    port.build.build_all(["flash_decode"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def case(*a):
        return cs.make_layout_case(gen, port.quantize.Int8KV, *a)

    cases = {
        "decode_float": ("decode", case(False, None, 4, 1, 576,
                                        [0, 1, 37, 576], [0, 1, 1, 1], bf)),
        "decode_float_full": ("decode", case(False, None, 4, 1, 576,
                                             [576] * 4, [1] * 4, bf)),
        "decode_int8_paged_bs8": ("decode", case(True, 8, 4, 1, 576,
                                                 [0, 1, 37, 576],
                                                 [0, 1, 1, 1], bf)),
        "decode_empty": ("decode", case(False, None, 4, 1, 576, [0] * 4,
                                        [0] * 4, bf)),
        "chunk_float": ("chunk", case(False, None, 1, 64, 576, [448], [44],
                                      bf)),
        "chunk_int8_paged_bs64": ("chunk", case(True, 64, 1, 64, 576, [448],
                                                [44], bf)),
        "chunk_empty": ("chunk", case(False, None, 1, 64, 576, [0], [0],
                                      bf)),
    }
    planned = fd._plan
    times = {}
    try:
        for name, (kind, (q, k, v, qpos, pos, kvl, table)) in cases.items():
            qp = qpos[:, 0] if kind == "decode" else qpos
            b, hkv, r = q.shape[0], cs.HKV, q.shape[1] * cs.G
            chosen = planned(b, hkv, r, 576, bf, isinstance(k, tuple), cs.D)
            want = cs.plain_attention(ref, kind, *cs.f32_inputs(q, k, v), qp,
                                      pos, kv_len=kvl, block_table=table)
            kern = ops.decode_attention if kind == "decode" \
                else ops.chunk_attention
            for rows in ((chosen.rows,) if kind == "decode" else (16, 32, 64)):
                for split in (1, 2, 4, 8):
                    p = fd.Plan(chosen.kernel, rows, chosen.bk, chosen.stages,
                                split, (b, hkv, -(-r // rows) * split),
                                fd._smem(chosen.kernel, rows, cs.D,
                                         1 if isinstance(k, tuple) else 2,
                                         isinstance(k, tuple)))
                    fd._plan = lambda *a, p=p: p
                    out = kern(q, k, v, qp, pos, kv_len=kvl,
                               block_table=table)
                    torch.cuda.synchronize()
                    ratio = cs.tol_ratio(out, want)
                    cs.check(ratio <= 1, f"{name} rows {rows} split {split}:"
                             f" {ratio} of the limit")
                    ms = cs.time_ms(cs.wrapper_call(fd, kind, q, k, v, qp,
                                                    pos, kvl, table))
                    mark = " (the plan's)" if (rows, split) == (
                        chosen.rows, chosen.split) else ""
                    times[f"{name} rows {rows} split {split}"] = ms
                    print(f"  {name:22s} rows {rows:2d} split {split}:"
                          f" {ms:.5f} ms, {ratio:.3f} of the limit{mark}",
                          flush=True)
                    fd._plan = planned
    finally:
        fd._plan = planned
    gpu = cs.gpu_line()
    print(gpu)
    print(json.dumps({"gpu": gpu, "wrapper_alone_ms": times}))


if __name__ == "__main__":
    main()
