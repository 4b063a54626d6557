"""The bf16 ``flash_attention`` backward's gradient readings over seeds, on
the card: for each head dim and head layout (D 80 at 32/32 and 32/8
heads, D 128 at 32/32 and 16/8, D 256 at 8/4; causal, S 2,048) and three
input seeds, each gradient's largest share of ``chip_smoke.py``'s limit
at ``FA_GRAD_ATOL``, the element where it is reached (its magnitude over
the median), the largest excess beyond the output's rounding in units of
the median (what ``FA_GRAD_ATOL`` and ``FA_WIDE_GRAD_ATOL`` are set from),
and how many elements differ from the plain value rounded once; then the
control's shares of both limits: the plain backward with P or dS rounded
once to bf16 (``bwd_rounded_once``), which each limit must fail:

    python scripts/chip_fa_grad_readings.py [tree]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
from chip_int8_phases import load_smoke

# (D, Hq, Hkv, B)
LAYOUTS = ((80, 32, 32, 1), (128, 32, 32, 1), (128, 16, 8, 4),
           (256, 8, 4, 1), (80, 32, 8, 1))
SEEDS, SEQ = (9, 10, 11), 2048


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=".",
                    help="root of a checkout holding chip_smoke.py")
    cs = load_smoke(Path(ap.parse_args().tree).resolve())
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the readings need one GPU")
    port = cs.load_port()
    fa, ref = port.fa, port.ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for d, hq, hkv, b in LAYOUTS:
        for seed in SEEDS:
            gen = torch.Generator(device=cs.DEV).manual_seed(seed)
            q, do = (torch.randn(b, SEQ, hq, d, generator=gen,
                                 device=cs.DEV).to(torch.bfloat16)
                     for _ in range(2))
            k, v = (torch.randn(b, SEQ, hkv, d, generator=gen,
                                device=cs.DEV).to(torch.bfloat16)
                    for _ in range(2))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                           causal=True)
            want = ref.flash_attention_bwd_ref(q.float(), k.float(),
                                               v.float(), out.float(),
                                               do.float(), True, 0)
            res = []
            for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                wa = w.abs()
                med = float(wa.median())
                diff = (g.float() - w).abs()
                share = diff / (2.0 ** -8 * wa + cs.FA_GRAD_ATOL * med)
                i = int(share.argmax())
                at = tuple(int(t) for t in torch.unravel_index(
                    torch.tensor(i), share.shape))
                off = int((g.float() != w.to(torch.bfloat16).float()).sum())
                res.append(f"{name}: share {float(share.max()):.3f} at {at}"
                           f" |w|/med {float(wa.flatten()[i]) / med:.1f}"
                           f" excess/med"
                           f" {cs.grad_reading(g, w)[0]:.3g} off-rounding"
                           f" {off}/{g.numel()}")
            once = cs.bwd_rounded_once(ref, q, k, v, out, do, True, 0)
            wide = cs.FA_WIDE_GRAD_ATOL
            ctl = [f"{name} {cs.grad_reading(g, w, wide)[1]:.3f}"
                   f" / {cs.grad_reading(g, w)[1]:.3f}"
                   for name, g, w in zip(("dS->dq", "dS->dk", "P->dv"), once,
                                         want)]
            print(f"D {d} {hq}/{hkv} B {b} seed {seed}: " + "; ".join(res)
                  + "; rounded once, shares of the wide / index limits: "
                  + ", ".join(ctl), flush=True)
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
