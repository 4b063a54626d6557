"""A traced step's costs: FLOPs, memory traffic, collective traffic and
peak live memory, counted op by op.

The counterpart of ``repro.roofline.collect``.  The reference walks the
HLO text of its compiled step; the port compiles no HLO, so a
``TorchDispatchMode`` (``StepCounter``) sees every ATen operation and
every ``repro_torch::`` kernel operator the step runs, on the card, on
the CPU or on the ``meta`` device (shapes alone: the dry run), and sums
the same ``WeightedCosts`` fields:

* **FLOPs**: ``2·|out|·K`` for every ``mm``/``addmm``/``bmm``/``baddbmm``
  and convolution (a convolution's backward: the same for each gradient
  it makes); a kernel operator counts the work its mask keeps
  (``kernel_flops``: a masked tile is not counted), the arithmetic of
  ``chip_smoke.py``'s bounds, which share these functions.  It counts
  the kernel's work on every device, so a run on the CPU (where an
  operator runs its plain version) counts what the card and the meta
  trace count.
* **bytes_accessed**: inputs plus outputs of every op that is not a view.
  Eager PyTorch runs each op as its own kernel, so op granularity is the
  eager program's traffic, the counterpart of the reference's fusion
  granularity.  Gathers count twice their output, scatters three times
  their update and a copy twice its source, as the reference counts
  slices, gathers and scatters.
* **bytes_min**: the same for products, the kernels' operators, copies,
  gathers and index ops only (the counterpart of "dots, collectives,
  slices": the traffic no fusion removes).
* **collectives**: the c10d functional ops by kind, with the reference's
  ring arithmetic (``_ring_bytes``); one card runs none.
* **peak live bytes**: the storages the step makes (a view counts once,
  with its base), from their making to their freeing, at their largest
  sum; what the step was given is not counted (``launch/dryrun.py`` adds
  it as the argument bytes).

``weighted(n)`` multiplies what is counted inside it by ``n``: the dry
run traces the train step's microbatch loop once and weights it by the
number of microbatches, where the reference weights a while body by its
trip count.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


_aten = torch.ops.aten


# ---------------------------------------------------------------------------
# The kernels' work (shared with chip_smoke.py's bounds)
# ---------------------------------------------------------------------------
def attention_pairs(sq: int, causal: bool, window: int,
                    skv: Optional[int] = None) -> int:
    """The (query, key) pairs an index mask keeps in one (batch, head):
    key j visible to row i when ``j <= i`` (causal) and ``j > i - window``
    (window > 0); keys of another length (``skv``) are all visible."""
    if skv is not None and skv != sq:
        return sq * skv
    s = sq
    total = 0
    for i0 in range(0, s, 1 << 16):           # in blocks: s may be 2^19
        i = torch.arange(i0, min(s, i0 + (1 << 16)), dtype=torch.int64)
        lo = (i - window + 1).clamp(min=0) if window > 0 \
            else torch.zeros_like(i)
        hi = i + 1 if causal else torch.full_like(i, s)
        total += int((hi - lo).sum())
    return total


def attention_flops(d: int, pairs: int, heads: int) -> int:
    """Two products (scores, then P·V) of 2·D each per kept (query, key)
    pair and query head."""
    return 4 * d * pairs * heads


# the backward recomputes the scores and makes dP, dQ, dK and dV: 2.5
# times the forward's products
ATTENTION_BWD_FACTOR = 2.5


def int8_matmul_ops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def mamba_scan_flops(b: int, s: int, d: int, n: int) -> int:
    """7 f32 operations a (t, d, n) and 1 a (t, d)."""
    return 7 * b * s * d * n + b * s * d


def mamba_scan_bwd_flops(b: int, s: int, d: int, n: int) -> int:
    """20 f32 operations a (t, d, n): the state and its decay, the carried
    gradient, and the sums of dx, ddt, dA, dB and dC."""
    return 20 * b * s * d * n


def mel_frontend_flops(frames: int, l: int, nbins: int, n_mels: int) -> int:
    """The two DFT products and the mel product of each frame."""
    return frames * (4 * l * nbins + 2 * nbins * n_mels)


def _numel(shape: Iterable[int]) -> int:
    n = 1
    for x in shape:
        n *= int(x)
    return n


def _fa_flops(q, k, causal, window) -> int:
    b, sq, hq, d = q.shape
    return attention_flops(d, attention_pairs(sq, causal, window,
                                              k.shape[1]), b * hq)


def _decode_flops(q, k, block_table, window) -> int:
    """Every cache entry of each slot (``kv_len`` is data: the shapes say
    how many entries a slot holds), or its window."""
    b, rows, hq, d = q.shape
    entries = k.shape[1] if block_table is None \
        else block_table.shape[1] * k.shape[1]
    if window > 0:
        entries = min(entries, window)
    return attention_flops(d, rows * entries, b * hq)


def kernel_flops(name: str, args) -> int:
    """The work of a ``repro_torch::`` operator call from its arguments'
    shapes (the schema's order)."""
    if name == "flash_attention":
        q, k, _, _, _, causal, window = args
        return _fa_flops(q, k, causal, window)
    if name == "flash_attention_bwd":
        q, k, causal, window = args[0], args[1], args[8], args[9]
        return int(ATTENTION_BWD_FACTOR * _fa_flops(q, k, causal, window))
    if name == "flash_decode":
        q, k, block_table, window = args[0], args[1], args[8], args[9]
        return _decode_flops(q, k, block_table, window)
    if name == "int8_matmul":
        x_q, w_q = args[0], args[1]
        return int8_matmul_ops(x_q.shape[0], w_q.shape[0], x_q.shape[1])
    if name in ("mamba_scan", "mamba_scan_bwd"):
        x, b_mat = args[0], args[2]
        b, s, d = x.shape
        fn = mamba_scan_flops if name == "mamba_scan" \
            else mamba_scan_bwd_flops
        return fn(b, s, d, b_mat.shape[-1])
    if name == "mel_frontend":
        frames, _, dft_cos, _, mel_fb = args
        return mel_frontend_flops(_numel(frames.shape[:-1]),
                                  frames.shape[-1], dft_cos.shape[1],
                                  mel_fb.shape[1])
    raise KeyError(f"no work formula for repro_torch::{name}")


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------
@dataclass
class WeightedCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    bytes_min: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(
        default_factory=lambda: defaultdict(
            lambda: {"count": 0.0, "bytes": 0.0, "ring_bytes": 0.0}))

    def add(self, other: "WeightedCosts", w: float = 1.0):
        self.flops += other.flops * w
        self.bytes_accessed += other.bytes_accessed * w
        self.bytes_min += other.bytes_min * w
        for kind, rec in other.collectives.items():
            mine = self.collectives[kind]
            for k in rec:
                mine[k] += rec[k] * w


def _ring_bytes(kind: str, nbytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(nbytes) * (g - 1)   # result shape is the shard
    return float(nbytes)                 # collective-permute


def total_collective_bytes(colls: Dict[str, Dict[str, float]],
                           key: str = "ring_bytes") -> float:
    return sum(v[key] for v in colls.values())


def _packets(*names) -> frozenset:
    return frozenset(getattr(_aten, n) for n in names if hasattr(_aten, n))


_PRODUCTS = _packets("mm", "addmm", "bmm", "baddbmm")
_CONVS = _packets("convolution", "_convolution")
_GATHERS = _packets("index", "gather", "index_select", "embedding",
                    "take_along_dim")
_SCATTERS = _packets("index_put", "index_put_", "_index_put_impl_",
                     "scatter", "scatter_", "scatter_add", "scatter_add_",
                     "index_add", "index_add_", "index_copy", "index_copy_",
                     "slice_scatter", "select_scatter",
                     "embedding_dense_backward")
_COPIES = _packets("copy_", "clone", "_to_copy", "cat", "stack",
                   "_unsafe_index")
_FREE = _packets("empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided", "detach", "lift_fresh", "alias")
# the c10d functional collectives: kind, and where the group size is
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def storage_key(t: torch.Tensor) -> int:
    """The identity of a tensor's storage (its views share it)."""
    return t.untyped_storage()._cdata


def unique_nbytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the storages under ``tensors``, each counted once."""
    seen: Dict[int, int] = {}
    for t in tensors:
        seen[storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class StepCounter(TorchDispatchMode):
    """Counts a step's costs while active (see the module docstring).
    ``costs`` holds the ``WeightedCosts``; ``op_flops`` the FLOPs by op
    (``aten.mm``, ``repro_torch.flash_attention``, ...); ``launches`` the
    kernel operators' calls by name; ``peak_bytes`` the largest sum of
    live storages made inside.  Every operator call is one node, counted
    with its kernel's work (``kernel_flops``)."""

    def __init__(self):
        super().__init__()
        self.costs = WeightedCosts()
        self.op_flops: Dict[str, float] = defaultdict(float)
        self.launches: Dict[str, float] = defaultdict(float)
        self.weight = 1.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}

    @contextlib.contextmanager
    def weighted(self, w: float):
        """Count what runs inside ``w`` times (a loop traced once)."""
        prev, self.weight = self.weight, self.weight * w
        try:
            yield self
        finally:
            self.weight = prev

    # -- live memory --------------------------------------------------
    def _born(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._died, key)

    def _died(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch -----------------------------------------------------
    def _add(self, name: str, flops: float, nbytes: float, minimal: bool):
        w = self.weight
        self.costs.flops += flops * w
        self.costs.bytes_accessed += nbytes * w
        if minimal:
            self.costs.bytes_min += nbytes * w
        if flops:
            self.op_flops[name] += flops * w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        ns = func.namespace
        if ns == "repro_torch":
            name = packet.__name__
            ins = _tensors(args)
            out = func(*args, **kwargs)
            self._account_new(func, out)
            self.launches[name] += self.weight
            self._add(f"repro_torch.{name}", kernel_flops(name, args),
                      _nbytes(ins) + _nbytes(_tensors(out)), True)
            return out
        out = func(*args, **kwargs)
        if ns == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            self._collective(packet.__name__, args, out)
            return out
        if packet in _FREE:
            self._account_new(func, out)
            return out
        schema = func._schema
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return out                                  # a view
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        if not any(r.alias_info is not None for r in schema.returns) \
                and outs and {storage_key(t) for t in outs} \
                <= {storage_key(t) for t in ins}:
            return out                # a view by another name (_unsafe_view)
        self._account_new(func, out)
        flops = 0
        if packet in _PRODUCTS:
            a = args[1] if packet in (_aten.addmm, _aten.baddbmm) else args[0]
            flops = 2 * outs[0].numel() * a.shape[-1]
        elif packet in _CONVS:
            w = args[1]
            flops = 2 * outs[0].numel() * _numel(w.shape[1:])
        elif packet is getattr(_aten, "convolution_backward", None):
            grad_out, w = args[0], args[2]
            mask = args[-1]
            per = 2 * grad_out.numel() * _numel(w.shape[1:])
            flops = per * (int(bool(mask[0])) + int(bool(mask[1])))
        if packet in _GATHERS:
            nbytes = 2 * _nbytes(outs)
        elif packet in _SCATTERS:
            upd = ins[2] if len(ins) > 2 else outs[0]
            nbytes = 3 * _nbytes([upd])
        elif packet is _aten.copy_:
            nbytes = 2 * _nbytes(ins[1:2])
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        minimal = bool(flops) or packet in _GATHERS or packet in _SCATTERS \
            or packet in _COPIES
        self._add(str(packet), flops, nbytes, minimal)
        return out

    def _account_new(self, func, out) -> None:
        """Start the life of every storage ``func`` made (an output that
        aliases an input is no new storage)."""
        rets = func._schema.returns
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            r = rets[i] if i < len(rets) else rets[-1]
            if r.alias_info is None:
                self._born(t)

    def _collective(self, name: str, args, out) -> None:
        kind = _COLLECTIVES[name]
        if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            g = int(args[1] if name == "all_gather_into_tensor" else args[2])
        elif torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            g = torch.distributed.get_world_size()
        else:
            g = 1
        nbytes = _nbytes(_tensors(out))
        rec = self.costs.collectives[kind]
        rec["count"] += self.weight
        rec["bytes"] += nbytes * self.weight
        rec["ring_bytes"] += _ring_bytes(kind, nbytes, g) * self.weight
        for t in _tensors(out):
            self._born(t)
