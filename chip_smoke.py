#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each a hard failure (non-zero exit, no result line):

1. Build the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   and print the build time and ptxas' register/shared-memory report.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (internlm2-1.8b: Hkv 8, G 2, D 128): decode with
   4 slots at kv_len {0, 1, 37, S}, chunk prefill of C = 64 with 20 pad
   rows, at S = 576 and S = 555.  Tolerance, elementwise against the plain
   version computed in f32 from the same inputs: in bf16, the output's own
   rounding (2^-8 of its size) plus 1e-5; in f32, 1e-5.  Each kernel's
   median time over 30 launches (L2 flushed before each, as the serving
   path finds it), the plain version's, the byte/operation bound and
   ``F.scaled_dot_product_attention``'s time as a yardstick (the port
   never calls it).
3. Serve eight requests through ``ContinuousBatchServer`` at the full
   width of internlm2-1.8b (24 layers, d_model 2048, 16/8 heads, d_ff 8192,
   vocab 92544 padded to 94208), bf16, random weights from a seeded
   generator on the card: 4 slots, prefill chunk 64, 32 new tokens each,
   max_prompt 512 (capacity 576).  Every request must return 32 tokens in
   the padded vocabulary; each kernel's launch count in that run must equal
   layers x steps as the server's metrics report them.  Then, over four
   seeds, chunk, ragged-chunk and decode steps are run through the kernels
   and through the plain attention (f32 from the same bf16 cache, rounded
   once to bf16 as the kernels round) on copies of the same cache: every
   layer's attention call must be within the kernel tolerance of the plain
   version on its own inputs, and the logits must agree at atol
   ``LOGIT_ATOL`` (24 bf16 layers amplify single-ulp rounding
   differences; PERF.md gives the readings behind the limit), with equal
   greedy tokens on at least 90% of the compared rows.  The main oracle
   is exact: a small float32 config (head_dim 128) served through the
   kernels must give the same greedy tokens as the plain path on the CPU.
   Last, a profile of decode and chunk steps says where a step's time goes
   (host wall, device busy, attention, GEMMs).

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Needs one GPU; exits non-zero without
one, or without the rest of the repository beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPLACES = {"flash_decode": "src/repro/kernels/flash_decode.py:147",
            "flash_chunk_prefill": "src/repro/kernels/flash_decode.py:334"}
SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
HKV, G, D = 8, 2, 128
DEV = "cuda"
# A bf16 output may differ from the f32 plain value by its own rounding,
# at most 2^-8 of its size, plus the f32 summation-order slack (below 1e-6
# in the f32 check); an f32 output by that slack alone.
TOL = {torch.bfloat16: (2.0 ** -8, 1e-5), torch.float32: (0.0, 1e-5)}
# Twice the largest of 16 serving-step readings on the H100 (0.1328),
# rounded up to a power of two; PERF.md gives the readings.
LOGIT_ATOL = 0.5
GREEDY_EQUAL_MIN = 0.9    # share of compared rows (95.2% read)
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def import_port():
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    check(Path(repro_torch.__file__).resolve().parents[1] == src,
          f"imported repro_torch from {repro_torch.__file__}, not {src}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
_flush_buf = None


def flush_l2() -> None:
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call.  The stream is first held by a spin
    kernel while every launch is queued, so the events time the kernels
    back to back, not the host's launch overhead; the L2 is flushed
    before each call, as the serving path finds it cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)     # ~60 ms: longer than the queueing
    pairs = []
    for _ in range(reps):
        flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def tol_ratio(out: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |out - want| in units of the elementwise limit of
    ``out``'s dtype: <= 1 passes."""
    rtol, atol = TOL[out.dtype]
    lim = rtol * want.abs() + atol
    return float(((out.float() - want).abs() / lim).max())


def make_case(gen, b, c, s, fills, reals, dtype):
    """Slot i holds ``fills[i]`` entries at positions 0.., the rest −1;
    its ``reals[i]`` queries sit at the last positions, pad rows at −1."""
    dev = DEV
    q = torch.randn(b, c, HKV * G, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, HKV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, HKV, D, generator=gen, device=dev).to(dtype)
    pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    qpos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    for i, (n, r) in enumerate(zip(fills, reals)):
        pos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev)
        qpos[i, :r] = torch.arange(n - r, n, dtype=torch.int32, device=dev)
    kvl = torch.tensor(fills, dtype=torch.int32, device=dev)
    return q, k, v, qpos, pos, kvl


def bound_ms(q, k, qpos, pos, kvl) -> tuple:
    """Least time for this call: each input read once (the live K/V rows,
    their positions, q and the query positions), the output written once;
    operations: 4·D per (query row, valid entry, head) pair."""
    esize = k.element_size()
    live = int(kvl.clamp(max=k.shape[1]).sum())
    nbytes = (2 * live * HKV * D * esize + live * 4 + 2 * q.numel() * esize
              + qpos.numel() * 4 + kvl.numel() * 4)
    idx = torch.arange(k.shape[1], device=k.device)
    valid = ((pos[:, None, :] >= 0) & (pos[:, None, :] <= qpos[:, :, None])
             & (idx[None, None, :] < kvl[:, None, None]))
    ops = 4 * D * int(valid.sum()) * HKV * G
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, qpos, pos, kvl):
    """One F.scaled_dot_product_attention call over the same function,
    inputs laid out as it wants them beforehand."""
    qs = q.transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    idx = torch.arange(k.shape[1], device=k.device)
    mask = ((pos[:, None, :] >= 0) & (pos[:, None, :] <= qpos[:, :, None])
            & (idx[None, None, :] < kvl[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def check_kernels(ops, ref):
    """Both kernels against the plain versions; returns the timed rows."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for s in (576, 555):
        for dtype in (torch.bfloat16, torch.float32):
            cases = {
                "flash_decode": (make_case(gen, 4, 1, s, [0, 1, 37, s],
                                           [0, 1, 1, 1], dtype),
                                 ops.decode_attention,
                                 ref.decode_attention_ref),
                "flash_chunk_prefill": (make_case(gen, 1, 64, s, [448], [44],
                                                  dtype),
                                        ops.chunk_attention,
                                        ref.chunk_attention_ref),
            }
            for name, (case, kern, plain) in cases.items():
                q, k, v, qpos, pos, kvl = case
                qp = qpos[:, 0] if name == "flash_decode" else qpos
                out = kern(q, k, v, qp, pos, kv_len=kvl)
                torch.cuda.synchronize()
                want = plain(q.float(), k.float(), v.float(), qp, pos,
                             kv_len=kvl)
                err = float((out.float() - want).abs().max())
                ratio = tol_ratio(out, want)
                rtol, atol = TOL[dtype]
                print(f"  {name:20s} S={s} {str(dtype):15s} max|err| {err:.3g}"
                      f", {ratio:.3f} of the limit (rtol {rtol:g}, atol"
                      f" {atol:g})")
                check(ratio <= 1, f"{name} disagrees with its plain version"
                      f" at S={s}, {dtype}: {ratio} of the limit")
                if name == "flash_decode":
                    check(bool((out[0] == 0).all()), "empty slot not zero")
                else:
                    check(bool((out[0, 44:] == 0).all()), "pad rows not zero")
                if s != 576 or dtype != torch.bfloat16:
                    continue
                ms = time_ms(lambda: kern(q, k, v, qp, pos, kv_len=kvl))
                plain_ms = time_ms(lambda: plain(q, k, v, qp, pos,
                                                 kv_len=kvl))
                lib_ms = time_ms(sdpa_call(q, k, v, qpos, pos, kvl))
                b_ms, b_by = bound_ms(q, k, qpos, pos, kvl)
                rows[name] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": lib_ms}
                print(f"  {name:20s} kernel {ms:.4f} ms  plain {plain_ms:.4f}"
                      f" ms  sdpa {lib_ms:.4f} ms  bound {b_ms:.5f} ms"
                      f" ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: full-width serving
# ---------------------------------------------------------------------------
def serve_full(configs, init_params, server_mod, fd):
    cfg = configs.get("internlm2-1.8b")
    check(cfg.n_layers == 24 and cfg.d_model == 2048
          and cfg.padded_vocab() == 94208, f"unexpected config {cfg}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    print(f"  weights: {sum(p.numel() for p in params.parameters())} params"
          f" in {time.perf_counter() - t0:.1f} s")
    kw = dict(slots=4, prefill_chunk=64, max_new_tokens=32, max_prompt=512,
              device=DEV)
    warm = server_mod.ContinuousBatchServer(cfg, params, **kw)
    warm.submit([np.arange(9, dtype=np.int32)], max_new_tokens=2)
    warm.run()
    del warm

    rng = np.random.RandomState(0)
    lens = [9, 37, 64, 128, 200, 301, 450, 512]
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    srv = server_mod.ContinuousBatchServer(cfg, params, **kw)
    check(srv.capacity == 576, f"capacity {srv.capacity} != 576")
    reqs = srv.submit(prompts)
    fd.reset_launches()
    torch.cuda.synchronize()
    metrics = srv.run()
    torch.cuda.synchronize()
    launches = dict(fd.LAUNCHES)
    vpad = cfg.padded_vocab()
    for r in reqs:
        check(len(r.tokens) == 32, f"request {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= t < vpad for t in r.tokens),
              f"request {r.rid}: token out of [0, {vpad})")
    want = {"flash_decode": cfg.n_layers * metrics["decode_steps"],
            "flash_chunk_prefill": cfg.n_layers * metrics["prefill_chunks"]}
    check(launches == want, f"launches {launches} != layers x steps {want}")
    print(f"  launches {launches} = 24 x (decode steps, chunk steps)")
    print("  metrics " + json.dumps(metrics))
    return cfg, params, launches, metrics


def serve_small_vs_cpu(configs, init_params, server_mod):
    """The repo's token-exactness oracle on a small input: a float32
    internlm2-shaped config (2 layers, d_model 256, 2/1 heads of 128, the
    narrowest the kernels take) served through the kernels on the card
    gives the same greedy tokens as the plain path on the CPU, on the
    prompts and budgets of the CPU parity test."""
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"),
                              d_model=256, n_heads=2, n_kv_heads=1,
                              dtype="float32")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 11, 7, 16)]
    budgets = [5, 4, 6, 3]
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = {}
    for dev in ("cpu", DEV):
        srv = server_mod.ContinuousBatchServer(
            cfg, host.to(dev), slots=2, max_prompt=16, prefill_chunk=4,
            max_new_tokens=8, device=dev)
        reqs = srv.submit(prompts, max_new_tokens=budgets)
        srv.run()
        tokens[dev] = [r.tokens for r in reqs]
    check(tokens[DEV] == tokens["cpu"],
          f"small float32 serving: card {tokens[DEV]} != cpu {tokens['cpu']}")
    print(f"  small float32 serving, card == cpu tokens: {tokens[DEV]}")


def rounded_once(plain):
    """The plain attention in f32 from the same (bf16) inputs, rounded once
    to the working dtype, as the kernels compute it."""
    def call(q, k, v, *args, **kw):
        return plain(q.float(), k.float(), v.float(), *args, **kw).to(q.dtype)
    return call


def checked(kern, plain, worst, name):
    """``kern``, with each call's output held against the plain version on
    the same inputs (f32) at the kernel tolerance; the worst ratio to the
    limit goes to ``worst[name]``."""
    def call(q, k, v, *args, **kw):
        out = kern(q, k, v, *args, **kw)
        want = plain(q.float(), k.float(), v.float(), *args, **kw)
        worst[name] = max(worst.get(name, 0.0), tol_ratio(out, want))
        return out
    return call


def logits_vs_plain(cfg, params, kvcache, serve_step, layers, ops, ref,
                    seeds=(1, 2, 3, 4)):
    """Serving steps through the kernels against the same steps through
    the plain attention (``rounded_once``) on a copy of the same cache.

    For each seed: slots 1 and 3 are filled with 1..5 chunks, then a full
    chunk step (slot 1), a ragged chunk step (slot 3, 1..63 real rows) and
    two decode steps (slots 1 and 3 live, 0 and 2 idle) are compared on
    their live rows.  Inside the kernel runs every attention call of every
    layer is also held against the plain version on its own inputs, at
    the kernel tolerance: that check sees each layer's cache slice, rows
    and positions without the 24 layers' amplification of rounding.  The
    logits must agree at ``LOGIT_ATOL``, and the greedy tokens on at least
    ``GREEDY_EQUAL_MIN`` of the compared rows."""
    chunk = serve_step.make_chunk_prefill_step(cfg)
    decode = serve_step.make_slot_decode_step(cfg)
    wiring = {}
    kernel_path = mock.patch.multiple(
        layers,
        decode_attention=checked(ops.decode_attention,
                                 ref.decode_attention_ref, wiring,
                                 "flash_decode"),
        chunk_attention=checked(ops.chunk_attention, ref.chunk_attention_ref,
                                wiring, "flash_chunk_prefill"))
    plain_path = mock.patch.multiple(
        layers, decode_attention=rounded_once(ref.decode_attention_ref),
        chunk_attention=rounded_once(ref.chunk_attention_ref))

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEV)

    readings = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        cache = kvcache.alloc_decode_cache(cfg, 4, 576, DEV)
        fill = {0: 0, 1: 0, 2: 0, 3: 0}

        def chunk_run(slot, n_real):
            toks = np.zeros((1, 64), np.int32)
            poss = np.full((1, 64), -1, np.int32)
            toks[0, :n_real] = rng.randint(0, cfg.vocab_size, n_real)
            poss[0, :n_real] = np.arange(fill[slot], fill[slot] + n_real)
            args = (ints(toks), ints(poss), slot, ints([fill[slot] + 64]))
            fill[slot] += n_real
            return lambda c: chunk(params, c, *args)[1][0, :n_real]

        def decode_run():
            live = [1, 3]
            tok = ints([rng.randint(cfg.vocab_size) if i in live else 0
                        for i in range(4)])
            pos = ints([fill[i] for i in range(4)])
            kvl = ints([fill[i] + 1 if i in live else 0 for i in range(4)])
            for i in live:
                fill[i] += 1
            return lambda c: decode(params, c, tok, pos, kvl)[1][live]

        with kernel_path:
            for slot in (1, 3):
                for _ in range(rng.randint(1, 6)):
                    chunk_run(slot, 64)(cache)
        steps = [("chunk", lambda: chunk_run(1, 64)),
                 ("chunk_ragged", lambda: chunk_run(3, rng.randint(1, 64))),
                 ("decode", decode_run), ("decode", decode_run)]
        for name, make in steps:
            run = make()
            copy = {key: t.clone() for key, t in cache.items()}
            with kernel_path:
                got = run(cache).float()
            with plain_path:
                want = run(copy).float()
            check(torch.equal(cache["full_pos"], copy["full_pos"]),
                  f"{name}: stored positions differ")
            same = got.argmax(-1) == want.argmax(-1)
            readings.append(dict(
                seed=seed, step=name, rows=int(got.shape[0]),
                fill=[fill[1], fill[3]],
                max_abs_gap=float((got - want).abs().max()),
                logit_std=float(want.std()), argmax_equal=int(same.sum())))
            print("  logits " + json.dumps(readings[-1]))
    worst_gap = max(r["max_abs_gap"] for r in readings)
    equal = sum(r["argmax_equal"] for r in readings)
    rows = sum(r["rows"] for r in readings)
    print(f"  serving logits: largest gap {worst_gap:.4g} over"
          f" {len(readings)} steps (atol {LOGIT_ATOL}); greedy tokens equal"
          f" on {equal} of {rows} rows; every layer's attention within"
          f" {json.dumps(wiring)} of the kernel limit")
    check(set(wiring) == {"flash_decode", "flash_chunk_prefill"}
          and max(wiring.values()) <= 1,
          f"an attention call of the serving path disagrees with its plain"
          f" version: {wiring}")
    check(worst_gap <= LOGIT_ATOL, f"serving logits disagree: {worst_gap}")
    check(equal >= GREEDY_EQUAL_MIN * rows,
          f"greedy tokens equal on only {equal} of {rows} rows")
    return readings


# ---------------------------------------------------------------------------
# Phase 4: where a step's time goes
# ---------------------------------------------------------------------------
def _merged_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(spans):
        if ts >= end:
            total += dur
        elif ts + dur > end:
            total += ts + dur - end
        end = max(end, ts + dur)
    return total


def profile_steps(cfg, params, kvcache, serve_step):
    """Host wall time of decode steps (4 slots at fill 257..264) and chunk
    steps (64 tokens into slot 0 at fill 384..512), each ending in a host
    read of its tokens as in the server; then one ``torch.profiler`` pass
    over the same steps for device time by kernel family."""
    chunk = serve_step.make_chunk_prefill_step(cfg)
    decode = serve_step.make_slot_decode_step(cfg)
    cache = kvcache.alloc_decode_cache(cfg, 4, 576, DEV)
    rng = np.random.RandomState(2)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEV)

    def chunk_at(slot, c0):
        return chunk(params, cache, ints(rng.randint(0, cfg.vocab_size,
                                                     (1, 64))),
                     ints(np.arange(c0, c0 + 64)[None]), slot, ints([c0 + 64]))

    for slot in range(4):
        for c0 in range(0, 256, 64):
            chunk_at(slot, c0)
    steps = {
        "decode": (lambda i: decode(params, cache,
                                    ints(rng.randint(0, cfg.vocab_size, 4)),
                                    ints([256 + i] * 4), ints([257 + i] * 4)),
                   8),
        "chunk": (lambda i: chunk_at(0, 320 + 64 * (i % 3)), 3),
    }
    trace = Path(__file__).resolve().parent / "build" / "profile.json"
    trace.parent.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, (step, n) in steps.items():
        step(0)[0].cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(i)[0].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(n):
                step(i)[0].cpu()
        prof.export_chrome_trace(str(trace))
        kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        trace.unlink()
        fam = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
        by_name = {}
        for e in kernels:
            low = e["name"].lower()
            key = ("attention" if "attn_kernel" in low else
                   "gemm" if any(w in low for w in GEMM_NAMES) else "other")
            fam[key] += e["dur"] / 1e3 / n
            by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) \
                + e["dur"] / 1e3 / n
        busy = _merged_us([(e["ts"], e["dur"]) for e in kernels]) / 1e3 / n
        out[name] = dict(host_wall_ms=wall_ms, device_busy_ms=busy,
                         idle_share=1 - busy / wall_ms if wall_ms else None,
                         kernels_per_step=len(kernels) / n,
                         **{f"{k}_ms": v for k, v in fam.items()})
        print(f"  {name} step: " + json.dumps(out[name]))
        for kname, ms in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            print(f"    {ms:.4f} ms/step  {kname}")
    return out


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    import_port()
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers
    from repro_torch.models.params import init_params
    from repro_torch.serve import kvcache, serve_step
    from repro_torch.serve import server as server_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t0 = time.perf_counter()
    for name in build.SOURCES:
        t1 = time.perf_counter()
        log = build.build(name)
        print(f"  {name}: built in {time.perf_counter() - t1:.1f} s")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print("   " + line.strip()[:110])
            elif "registers" in line or "spill" in line:
                print("   " + line.strip())
    fd._lib()
    print(f"  build phase {time.perf_counter() - t0:.1f} s")

    print("phase 2: kernels against their plain versions")
    rows = check_kernels(ops, ref)

    print("phase 3: full-width serving, internlm2-1.8b bf16")
    cfg, params, launches, metrics = serve_full(configs, init_params,
                                                server_mod, fd)
    logits_vs_plain(cfg, params, kvcache, serve_step, layers, ops, ref)
    serve_small_vs_cpu(configs, init_params, server_mod)
    print("phase 4: where a step's time goes")
    profile_steps(cfg, params, kvcache, serve_step)
    print(f"  tokens_per_s {metrics['tokens_per_s']:.2f}  ttft_p50_s "
          f"{metrics['ttft_p50_s']:.4f}  ttft_p95_s {metrics['ttft_p95_s']:.4f}"
          f"  kv_cache_bytes {metrics['kv_cache_bytes']}")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **rows[name]) for name in ("flash_decode",
                                               "flash_chunk_prefill")]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
