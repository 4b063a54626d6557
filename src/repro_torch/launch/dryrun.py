"""Dry run: trace every (arch x shape) cell's step and estimate it.

    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun

The platform's static resource estimation (paper C2) applied to the
card: before touching the hardware, each cell's train, prefill or decode
step of the **full** config is traced on the ``meta`` device (shapes and
dtypes, no data, no memory) through the path the card runs, each kernel
one node (``kernels/ops.py``), under a ``StepCounter``
(``roofline/collect.py``).  The counts give the memory the step needs on
the card (``memory``), its FLOPs and bytes (``cost``), its collective
traffic (none on one card) and its roofline against the H100 model
(``roofline/hw.py``).  The dry run runs no kernel and needs no card: it
is an estimate made ahead of the hardware, not a CPU fallback of the
step.

The row is the reference's (``repro.launch.dryrun.run_cell``), with one
key replaced: the port compiles nothing, so ``t_trace_s`` (the trace's
seconds) stands where the reference has ``t_lower_s`` and
``t_compile_s``.  The mesh is the one-card mesh ``{"data": 1, "model":
1}``; a mesh of more devices (``--mesh multi``, the reference's 2 x 16 x
16) raises.  Memory, as the reference's ``memory_analysis``:
``argument_bytes`` (weights, optimizer state, batch, cache),
``output_bytes`` (what the step returns), ``alias_bytes`` (what it
updates in place: the weights and optimizer state of a train step, the
cache of a decode step), ``temp_bytes`` (the peak of the storages it
makes, less the outputs it makes) and ``per_device_hbm_bytes`` =
argument + temp + output - alias.  The train step's microbatch loop is
traced once and weighted by ``n_micro`` (the reference weights its scan
by the trip count).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch import configs, flags as perf_flags
from repro_torch.core.arch import SHAPES, ArchConfig, ShapeConfig, \
    shape_applicable
from repro_torch.core.tree import leaves
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_name
from repro_torch.models import api
from repro_torch.models.params import abstract_params, param_count
from repro_torch.roofline.collect import (StepCounter, storage_key,
                                          total_collective_bytes,
                                          unique_nbytes)
from repro_torch.roofline.hw import H100
from repro_torch.roofline.model import RooflineReport, model_flops
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.sharding.policy import logical_to_pspec, make_rules
from repro_torch.train import train_step as ts
from repro_torch.train.compression import init_residual
from repro_torch.train.optimizer import AdamWConfig, adamw_init

# the reference's choices for its 16-way model axis (q heads that do not
# divide it: context parallel; activations past its 16 GiB chip: SP); on
# one card no strategy changes a layout, and the choice is only recorded
DEFAULT_STRATEGY = {
    "gemma3-4b": "cp",
    "llama3.2-3b": "cp",
    "qwen2-vl-72b": "tp_sp",
    "dbrx-132b": "tp_sp",
}


def default_strategy(arch: str) -> str:
    return DEFAULT_STRATEGY.get(arch, "tp")


def one_card_mesh() -> Mesh:
    """The dry run's mesh: ``{"data": 1, "model": 1}``, shapes only."""
    return Mesh({"data": 1, "model": 1})


def default_n_micro(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    if shape.kind != "train":
        return 1
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    per_dp = 1 if param_count(cfg) > 2e10 else 2
    n = max(shape.global_batch // (dp * per_dp), 1)
    while shape.global_batch % n:
        n -= 1
    return n


def cache_shardings(cfg: ArchConfig, cache, mesh: Mesh, rules):
    """Each cache leaf's ``PartitionSpec`` by the reference's rule: the
    positions (batch, cache length), a conv window (batch, -, inner), an
    SSM state (batch, inner, ...), K/V (batch, cache length, KV heads,
    -); an ``Int8KV`` or ``SSMState`` field by its own name."""
    def assign(key: str, leaf: torch.Tensor):
        nd = leaf.dim()
        if "pos" in key:
            axes = (None,) * (nd - 2) + ("act_batch", "act_cache_seq")
        elif "conv" in key:
            axes = (None,) * (nd - 3) + ("act_batch", None, "act_dinner")
        elif "ssm" in key:
            axes = ((None,) * (nd - 4) + ("act_batch", "act_dinner", None,
                                          None)) if nd >= 4 else (None,) * nd
        else:
            axes = (None,) * (nd - 4) + ("act_batch", "act_cache_seq",
                                         "act_kv_heads", None)
        return logical_to_pspec(axes, rules, mesh, leaf.shape)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + [str(k)]) for k, v in tree.items()}
        if isinstance(tree, tuple):
            names = getattr(tree, "_fields", range(len(tree)))
            return type(tree)(*(walk(v, path + [str(n)])
                                for n, v in zip(names, tree)))
        return assign("/".join(path).lower(), tree)
    return walk(cache, [])


def trace_step(cfg: ArchConfig, shape: ShapeConfig, counter: StepCounter,
               *, n_micro: int = 1, remat: str = "full",
               grad_compression: Optional[str] = None, params=None,
               inputs=None):
    """Run the step of ``shape.kind`` under ``counter`` (None: uncounted,
    to time it): the train step (its microbatch loop's body once,
    weighted by ``n_micro``), the one-shot prefill, or the contiguous
    decode step.  ``params`` and
    ``inputs`` (a batch; for decode {"cache", "token", "position"})
    default to the abstract ones on ``meta``; given on another device,
    the same step runs there (a CPU run under ``StepCounter`` counts what
    the meta trace counts).  Returns the step's
    (arguments, outputs) as lists of trees."""
    if counter is None:
        counter = _Uncounted()
    if shape.kind == "train":
        return _trace_train(cfg, shape, n_micro, remat, grad_compression,
                            counter, params, inputs)
    params = abstract_params(cfg) if params is None else params
    if shape.kind == "prefill":
        inputs = api.prefill_input_specs(cfg, shape) if inputs is None \
            else inputs
        with counter:
            out = make_prefill_step(cfg)(params, inputs)
        return [leaves(params.tree()), list(inputs.values())], [out]
    specs = api.decode_input_specs(cfg, shape) if inputs is None else inputs
    with counter:
        out = make_decode_step(cfg)(params, specs["cache"], specs["token"],
                                    specs["position"])
    return [leaves(params.tree()), specs["cache"], specs["token"],
            specs["position"]], [out]


class _Uncounted(contextlib.nullcontext):
    def weighted(self, w: float):
        return contextlib.nullcontext()


def _trace_train(cfg, shape, n_micro, remat, grad_compression, counter,
                 params, batch):
    params = abstract_params(cfg, trainable=True) if params is None \
        else params
    plist = leaves(params.tree())
    dev = plist[0].device
    opt_state = adamw_init(params)      # on meta: the abstract state
    if grad_compression and grad_compression != "none":
        opt_state["residual"] = init_residual(params)
    batch = api.train_input_specs(cfg, shape) if batch is None else batch
    rows = shape.global_batch // n_micro
    micro = {k: v[:rows] for k, v in batch.items()}
    args = [plist, leaves(opt_state), list(batch.values())]
    with counter:
        # the microbatch loop's body, traced once, weighted by n_micro
        with counter.weighted(n_micro):
            if n_micro > 1:
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                       for p in plist]
            loss, grads = ts.loss_and_grads(cfg, params, plist, micro, remat)
            if n_micro > 1:
                for a, g in zip(acc, grads):
                    a.add_(g)
        if n_micro > 1:
            grads = [a / n_micro for a in acc]
        del micro
        params, opt_state, om = ts.apply_grads(
            params, opt_state, grads, AdamWConfig(), grad_compression)
        del grads
    outs = [leaves(params.tree()), leaves(opt_state), [loss],
            list(om.values())]
    return args, outs


def run_cell(arch: str, shape_name: str, *, mesh: Optional[Mesh] = None,
             strategy: Optional[str] = None, n_micro: Optional[int] = None,
             remat: str = "full", grad_compression: Optional[str] = None,
             opt_flags: Optional[Dict[str, bool]] = None) -> Dict[str, Any]:
    """Trace one cell's step on ``meta`` and return its row (see the
    module docstring)."""
    if opt_flags:
        perf_flags.set_flags(**opt_flags)
    mesh = mesh or one_card_mesh()
    if mesh.size != 1:
        raise NotImplementedError(
            f"the dry run traces one device's step: mesh {mesh_name(mesh)}"
            f" needs {mesh.size} devices (the port runs on one card)")
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "skipped", "why": why}
    strategy = strategy or default_strategy(arch)
    make_rules(strategy, decode=shape.kind == "decode")   # checks the name
    n_micro = n_micro or default_n_micro(cfg, shape, mesh)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "strategy": strategy, "n_micro": n_micro, "remat": remat,
        "n_chips": mesh.size, "params": param_count(cfg),
        "flags": dict(perf_flags.FLAGS),
    }

    counter = StepCounter()
    t0 = time.time()
    args, outs = trace_step(cfg, shape, counter, n_micro=n_micro,
                            remat=remat, grad_compression=grad_compression)
    t_trace = time.time() - t0
    memory = step_memory(args, outs, counter.peak_bytes)

    wc = counter.costs
    colls = {k: dict(v) for k, v in wc.collectives.items()}
    rep = RooflineReport(
        arch=arch, shape=shape_name, mesh=result["mesh"], n_chips=mesh.size,
        hlo_flops=wc.flops, hlo_bytes=wc.bytes_accessed,
        hlo_bytes_min=wc.bytes_min,
        collective_bytes=total_collective_bytes(colls),
        collective_detail=colls,
        per_device_hbm=float(memory["per_device_hbm_bytes"]),
        model_flops=model_flops(cfg, shape)).finalize(H100)
    # the trace runs the kernels' operators: no score matrix was counted,
    # so no score traffic is credited back (``roofline.model.
    # fused_adjustment`` credits the reference's analytic traffic, which a
    # trace of the plain attention would have counted)
    row = rep.row()
    fused = {"t_memory_min_fused_s": row["t_memory_min_s"],
             "roofline_fraction_fused": row["roofline_fraction"],
             "score_traffic_credit_bytes": 0.0,
             "score_traffic_note": (
                 "0: the trace runs the attention kernels' operators, which"
                 " keep the scores on chip, so the counted traffic holds"
                 " none to credit")}
    result.update({
        "status": "ok",
        "t_trace_s": round(t_trace, 2),
        "memory": memory,
        "cost": {"flops_per_device": wc.flops,
                 "bytes_per_device": wc.bytes_accessed,
                 "bytes_min_per_device": wc.bytes_min,
                 "flops_by_op": dict(counter.op_flops),
                 "kernel_calls": dict(counter.launches)},
        "collectives": colls,
        "roofline": {**row, **fused},
        "model_flops": rep.model_flops,
    })
    return result


def _tensors(tree) -> list:
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def step_memory(args, outs, peak_new: int) -> Dict[str, Any]:
    """The memory row of a traced step from its arguments and outputs
    (trees of tensors, as ``trace_step`` returns them) and the peak of
    the storages it made."""
    args, outs = _tensors(args), _tensors(outs)
    arg_keys = {storage_key(t) for t in args}
    argument = unique_nbytes(args)
    output = unique_nbytes(outs)
    alias = unique_nbytes(t for t in outs if storage_key(t) in arg_keys)
    temp = max(peak_new - (output - alias), 0)
    total = argument + temp + output - alias
    return {"argument_bytes": argument, "output_bytes": output,
            "temp_bytes": temp, "alias_bytes": alias,
            "per_device_hbm_bytes": total,
            "per_device_hbm_gib": round(total / 2**30, 3)}


def print_summary(res: Dict[str, Any]) -> None:
    if res.get("status") == "skipped":
        print(f"[skip] {res['arch']} x {res['shape']} x {res['mesh']}: "
              f"{res['why']}")
        return
    r = res["roofline"]
    print(f"[ok]   {res['arch']} x {res['shape']} x {res['mesh']} "
          f"strat={res['strategy']} micro={res['n_micro']} "
          f"trace={res['t_trace_s']}s")
    print(f"       hbm/dev={res['memory']['per_device_hbm_gib']} GiB "
          f"fits={r['fits_hbm']}  bottleneck={r['bottleneck']}")
    print(f"       t_comp={r['t_compute_s']}s t_mem={r['t_memory_s']}s "
          f"t_coll={r['t_collective_s']}s useful={r['useful_flops_ratio']} "
          f"roofline_frac={r['roofline_fraction']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--opt", action="store_true",
                    help="enable the perf flags (bf16_params + bf16_attn_p)")
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        mesh = make_production_mesh(multi_pod=True)
        raise NotImplementedError(
            f"--mesh multi: mesh {mesh_name(mesh)} needs {mesh.size}"
            f" devices (and the single pod's 256); the port's dry run"
            f" traces one card")
    if args.opt:
        perf_flags.set_flags(bf16_params=True, bf16_attn_p=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = list(configs.ALIASES) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}_{shape_name}_single"
            path = out / f"{tag}.json"
            if args.resume and path.exists():
                print(f"[resume] {tag} exists")
                continue
            try:
                res = run_cell(arch, shape_name, strategy=args.strategy,
                               n_micro=args.micro, remat=args.remat,
                               grad_compression=args.grad_compression)
            except Exception as e:  # a failure here is a bug: record it
                res = {"arch": arch, "shape": shape_name, "mesh": "1x1",
                       "status": "error", "error": str(e)[:2000],
                       "traceback": traceback.format_exc()[-4000:]}
                failures.append(tag)
            path.write_text(json.dumps(res, indent=1))
            if res["status"] == "error":
                print(f"[FAIL] {tag}: {res['error'][:200]}")
            else:
                print_summary(res)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
