"""EON Compiler analogue (paper C4): interpreter-less deployment, on the
H100.

Edge Impulse's EON Compiler generates C++ that calls kernels directly,
deleting the TFLM graph interpreter.  The JAX package's analogue is a
serialized XLA executable.  Here the interpreter is PyTorch's eager
dispatch: every op of a step goes through Python and the dispatcher, and
each kernel costs the host a launch.  The deployment artifact is the
step's **exported program** (``torch.export``, the bytes of
``torch.export.save``), with its static resource report.  Rehydrated on
the card, it is captured once as a **CUDA graph** and replayed: no Python,
no dispatch, no per-kernel launch on the host.  On the CPU it runs the
loaded program as it is (the plain versions of the kernels, no graph).

The hand-written kernels are custom operators (``kernels/ops.py``), so
the program holds each as one node, and the graph replays the same
kernels.  The counterpart of ``repro.core.eon_compiler``, with its names
and signatures; ``compile_fn`` takes example tensors where the JAX one
takes abstract shapes, since ``torch.export`` traces on the device the
step will run on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import tree
from repro_torch.kernels import ops


def normalize_cost_analysis(cost) -> Dict[str, float]:
    """The JAX package's ``compiled.cost_analysis()`` comes as a dict or a
    per-device list of dicts; this takes either to one dict.  Here the
    cost is a dict already (``compile_fn``'s flops), so it passes
    through."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else None
    return cost or {}


def _nbytes(obj) -> int:
    """Bytes of every tensor in a tree of dicts, tuples and named
    tuples."""
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(obj)
               if isinstance(t, torch.Tensor))


def _specs(obj):
    """A tree's tensors as ``meta`` tensors: shapes and dtypes, no
    memory (the JAX package's ``ShapeDtypeStruct``s)."""
    return pytree.tree_map_only(
        torch.Tensor, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), obj)


@contextlib.contextmanager
def _f32():
    """The port computes in f32: TF32 off for cuBLAS and cuDNN while a
    step is captured (a graph keeps the kernels chosen then)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class GraphStep:
    """An exported program replayed as a CUDA graph.

    The first call runs the program once (the call's real result: it also
    settles what a kernel sets up at its first launch), then captures it
    over static buffers; each later call copies its tensors into those
    buffers (from any device: host data is copied in) and replays the
    graph.  The arguments at the ``persistent`` positions (a step's weights
    and the cache it updates in place) are captured as the caller's own
    tensors: they must be the same tensors on every call, and a call that
    passes others raises.  An argument the step updates and returns (the
    cache) must be persistent, and comes back as the caller's tensor; the
    other outputs are the graph's own buffers, overwritten by the next
    call.  A capture that fails raises; nothing falls back to the eager
    program.

    ``captured_launches`` holds the kernel launches the capture recorded
    (``ops.launch_counts``), ``replays`` the replays since: the host
    counters count the first call's run and the capture, never a
    replay.  ``temp_bytes`` is what the capture reserved for the graph's
    private memory pool."""

    def __init__(self, module: Callable, persistent: Sequence[int] = ()):
        self.module = module
        self.persistent = tuple(persistent)
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.captured_launches: Dict[str, int] = {}
        self.temp_bytes = 0

    def _flatten(self, args):
        """The leaves of every argument, in order, the structure, and the
        argument each leaf belongs to."""
        leaves, specs, owner = [], [], []
        for a, arg in enumerate(args):
            flat, spec = pytree.tree_flatten(tree.as_tree(arg))
            leaves += flat
            specs.append(spec)
            owner += [a] * len(flat)
        return leaves, specs, owner

    def _unflatten(self, leaves, specs):
        out, i = [], 0
        for spec in specs:
            out.append(pytree.tree_unflatten(leaves[i:i + spec.num_leaves],
                                             spec))
            i += spec.num_leaves
        return out

    def __call__(self, *args):
        leaves, specs, owner = self._flatten(args)
        if self.graph is None:
            return self._capture(leaves, specs, owner)
        if specs != self._specs:
            raise ValueError("the step was captured for arguments of"
                             " another structure")
        for i, (leaf, static) in enumerate(zip(leaves, self._static)):
            if leaf is static:
                continue
            if i in self._held or not isinstance(leaf, torch.Tensor):
                raise ValueError(
                    f"argument leaf {i} is not what the step was captured"
                    " with: weights and cache are persistent")
            static.copy_(leaf)
        self.graph.replay()
        self.replays += 1
        return self._result(self._static_out, leaves)

    def _result(self, out, leaves):
        """``out`` with each output that is an argument replaced by the
        caller's tensor."""
        flat = [leaves[self._aliases[i]] if i in self._aliases else t
                for i, t in enumerate(out)]
        return pytree.tree_unflatten(flat, self._out_spec)

    def _capture(self, leaves, specs, owner):
        self._specs = specs
        self._held = {i for i, a in enumerate(owner)
                      if a in self.persistent}
        self._static = [leaf if i in self._held or
                        not isinstance(leaf, torch.Tensor)
                        else leaf.to(self.device, copy=True)
                        for i, leaf in enumerate(leaves)]
        static_args = self._unflatten(self._static, specs)
        with torch.no_grad(), _f32():
            first = self.module(*static_args)
        ids = {id(t): i for i, t in enumerate(self._static)}
        first_flat, self._out_spec = pytree.tree_flatten(first)
        self._aliases = {i: ids[id(t)] for i, t in enumerate(first_flat)
                         if id(t) in ids}
        if not set(self._aliases.values()) <= self._held:
            raise ValueError("the step returns an argument it was not told"
                             " is persistent")
        # the capture empties the allocator's cache first: empty it here,
        # so that what it reserves after is its own pool alone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), _f32(), torch.cuda.graph(graph):
            out = self.module(*static_args)
        after = ops.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.temp_bytes = torch.cuda.memory_reserved() - reserved
        self._static_out = pytree.tree_leaves(out)
        self.graph = graph
        return self._result(first_flat, leaves)


class _Program:
    """An exported program run as it is (the CPU's rehydrated step)."""

    def __init__(self, module: Callable):
        self.module = module

    def __call__(self, *args):
        with torch.no_grad():
            return self.module(*(tree.as_tree(a) for a in args))


@dataclasses.dataclass
class CompiledArtifact:
    name: str
    serialized: bytes                  # torch.export.save of the program
    input_specs: Any                   # the arguments as meta tensors
    memory: Dict[str, int]
    flops: float
    compile_time_s: float
    device: str = "cpu"                # where the program was exported
    persistent: Tuple[int, ...] = ()   # arguments captured in place

    @property
    def artifact_bytes(self) -> int:
        return len(self.serialized)

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(self))

    @staticmethod
    def load(path: Path) -> "CompiledArtifact":
        return pickle.loads(Path(path).read_bytes())

    def program(self) -> torch.export.ExportedProgram:
        return torch.export.load(io.BytesIO(self.serialized))

    def rehydrate(self) -> Callable:
        """Deserialize into a callable that never re-traces: on the card a
        ``GraphStep`` (captured at its first call, replayed after), on the
        CPU the loaded program."""
        module = self.program().module()
        if self.device == "cuda":
            return GraphStep(module, self.persistent)
        return _Program(module)


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _first_tensor(obj) -> torch.Tensor:
    return next(t for t in pytree.tree_leaves(obj)
                if isinstance(t, torch.Tensor))


def compile_fn(fn: Callable, *example_args, name: str = "fn",
               persistent: Sequence[int] = ()) -> CompiledArtifact:
    """Export ``fn(*example_args)`` on the examples' device and serialize
    it, with its resource report.

    ``fn`` first runs once eagerly on the examples, under
    ``FlopCounterMode``: that call gives ``flops`` (the custom operators
    have no formula and count 0: ``flash_decode``, ``int8_matmul``,
    ``mel_frontend``, ``mamba_scan``) and ``output_bytes``, and it fills
    the module-level caches a step reads (the DSP tables, the int8
    divisor) with real tensors before ``torch.export`` traces with fake
    ones; the export then bakes them in as constants.  A function that
    updates its arguments in place updates the examples.  ``memory``
    holds the XLA report's keys: ``argument_bytes`` and ``output_bytes``
    exactly, ``code_bytes`` the serialized program's length, and
    ``temp_bytes`` what a CUDA graph capture of the program on the
    examples reserves for its private pool on the card (0 on the CPU,
    where nothing is captured).  ``persistent`` names the arguments a
    rehydrated ``GraphStep`` captures in place (``GraphStep``)."""
    t0 = time.time()
    args = tuple(tree.as_tree(a) for a in example_args)
    device = _first_tensor(args).device
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        out = fn(*args)
    output_bytes = _nbytes(out)
    del out
    # export traces detached views: the weights may be nn.Parameters
    plain = pytree.tree_map_only(torch.Tensor, lambda t: t.detach(), args)
    with torch.no_grad():
        exported = torch.export.export(_Fn(fn), plain)
    exported.example_inputs = None      # not saved: they hold the weights
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    temp = 0
    if device.type == "cuda":
        step = GraphStep(exported.module(), persistent)
        step(*args)
        temp = step.temp_bytes
        del step
    return CompiledArtifact(
        name=name, serialized=blob, input_specs=_specs(args),
        memory={"argument_bytes": _nbytes(args),
                "output_bytes": output_bytes,
                "temp_bytes": temp,
                "code_bytes": len(blob)},
        flops=float(counter.get_total_flops()),
        compile_time_s=time.time() - t0, device=device.type,
        persistent=tuple(persistent))


def compile_impulse(impulse, batch_size: int = 1,
                    int8: bool = False) -> CompiledArtifact:
    """Deploy an Impulse: one program covering DSP + NN end to end, its
    frozen weights baked in (the float ``params``, or the int8 weights
    dequantized, ``fake_quant_params``, for ``int8=True``).

    The example input is a zero batch.  ``compile_fn`` runs it through
    ``impulse.features`` eagerly before exporting: the DSP block builds its
    window, DFT and mel tables at first use and keeps them
    (``functools.lru_cache``), so a first use inside ``torch.export`` would
    keep traced tensors there and break every later eager call."""
    if isinstance(impulse.input_shape, int):
        raw_shape = (batch_size, impulse.input_shape)
    else:
        raw_shape = (batch_size,) + tuple(impulse.input_shape)
    raw = torch.zeros(raw_shape, dtype=torch.float32, device=impulse.device)

    if int8:
        if impulse.qparams is None:
            raise RuntimeError("run quantize() first")
        from repro_torch.core.quantize import fake_quant_params
        frozen = fake_quant_params(impulse.qparams)
    else:
        frozen = impulse.params

    def deploy(x):
        return impulse.learn.apply(frozen, impulse.dsp.apply(x))

    return compile_fn(deploy, raw,
                      name=f"{impulse.dsp.name}+{impulse.learn.name}"
                           f"{'+int8' if int8 else ''}")


def compile_serve_decode(cfg, params, *, slots: int, capacity: int,
                         policy=None, pool_blocks: Optional[int] = None,
                         block_size: Optional[int] = None
                         ) -> CompiledArtifact:
    """Serve-from-artifact (paper C4, end to end): the continuous-batching
    decode step as a ``CompiledArtifact``, whose rehydrated step the
    engines' hot loop replays (``use_artifact``).

    ``slots`` is the engine's decode batch, ``capacity`` the per-slot KV
    rows; ``policy`` (``PrecisionPolicy``) selects the int8 variant
    (``QTensor`` weights, an ``Int8KV`` cache).  The signature is the JAX
    package's, ``(params, cache, token, position, kv_len)``: the weights
    are an **input** (the nested dict of ``ParamTree.tree()``, never
    constants: at full width they would put gigabytes into
    ``serialized``), and the cache is updated in place, as the eager step
    updates it.  Both are captured in place on the card (``GraphStep``):
    the engine's own weights and cache.  ``pool_blocks`` exports the
    **paged** step instead, ``(params, cache, token, position, kv_len,
    block_table)`` with the (slots, capacity // BS) int32 table, and the
    report then prices the pool per block.  ``memory`` adds to
    ``compile_fn``'s keys ``kv_cache_bytes`` (both precisions:
    ``kv_cache_bytes_float``), ``kv_block_bytes``/``kv_pool_blocks``
    (paged) and ``param_bytes``, as the JAX package computes them."""
    from repro_torch.models.params import TreeView
    from repro_torch.serve.kvcache import (abstract_paged_cache,
                                           alloc_decode_cache,
                                           alloc_paged_cache,
                                           decode_cache_nbytes,
                                           kv_block_size,
                                           kv_pool_block_bytes)
    from repro_torch.serve.serve_step import (make_paged_decode_step,
                                              make_slot_decode_step)

    paged = pool_blocks is not None
    step = (make_paged_decode_step(cfg, policy) if paged
            else make_slot_decode_step(cfg, policy))
    weights = tree.as_tree(params)
    device = _first_tensor(weights).device

    def deploy(params, cache, *rest):
        return step(TreeView(params), cache, *rest)

    def vec():
        return torch.zeros((slots,), dtype=torch.int32, device=device)

    suffix = ""
    if policy is not None and policy.weights == "int8":
        suffix = "-int8"
    if paged:
        bs = block_size or kv_block_size(capacity)
        cache = alloc_paged_cache(cfg, slots, capacity, pool_blocks, device,
                                  policy, bs)
        table = torch.zeros((slots, capacity // bs), dtype=torch.int32,
                            device=device)
        art = compile_fn(
            deploy, weights, cache, vec(), vec(), vec(), table,
            name=f"{cfg.name}-decode-b{slots}-s{capacity}"
                 f"-paged{pool_blocks}x{bs}{suffix}", persistent=(0, 1))
        art.memory["kv_block_bytes"] = kv_pool_block_bytes(cfg, capacity,
                                                           policy, bs)
        art.memory["kv_pool_blocks"] = pool_blocks
    else:
        cache = alloc_decode_cache(cfg, slots, capacity, device, policy)
        art = compile_fn(
            deploy, weights, cache, vec(), vec(), vec(),
            name=f"{cfg.name}-decode-b{slots}-s{capacity}{suffix}",
            persistent=(0, 1))
    art.memory["kv_cache_bytes"] = decode_cache_nbytes(cache)
    art.memory["kv_cache_bytes_float"] = (
        art.memory["kv_cache_bytes"] if suffix == ""
        else decode_cache_nbytes(
            abstract_paged_cache(cfg, slots, capacity, pool_blocks, None,
                                 block_size)
            if paged else alloc_decode_cache(cfg, slots, capacity, "meta",
                                             None)))
    art.memory["param_bytes"] = _nbytes(weights)
    return art


def measure_dispatch_overhead(fn: Callable, *args, iters: int = 20
                              ) -> Dict[str, float]:
    """Interpreter against EON: ``fn`` called eagerly (op by op, through
    Python and the dispatcher) against its rehydrated artifact (on the
    card a replayed CUDA graph), each call ending in a sync.  A function
    that updates its arguments in place updates them on every call."""
    device = _first_tensor(args).device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(call) -> float:
        call()                              # warm (the artifact: capture)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
            sync()
        return (time.perf_counter() - t0) / iters

    with torch.no_grad():
        eager = timed(lambda: fn(*args))
    deployed = compile_fn(fn, *args).rehydrate()
    aot = timed(lambda: deployed(*args))
    return {"eager_us": eager * 1e6, "aot_us": aot * 1e6,
            "speedup": eager / max(aot, 1e-12)}
