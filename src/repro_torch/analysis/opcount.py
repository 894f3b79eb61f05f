"""Per-device FLOPs, bytes and collective traffic of a step, counted as it
runs: the port's stand-in for ``repro.analysis.hlo``.

The reference mines the optimized, SPMD-partitioned HLO text of a compiled
step, which is the per-device program. PyTorch emits no HLO, so here the
step runs (on meta tensors for a dry run, or on real ones) under
``OpCounter``, a ``TorchDispatchMode`` that sees every ATen op on a plain
tensor. A DTensor op is let through to DTensor's own dispatch
(``NotImplemented``), which runs it on this rank's local shards and calls
the collectives its placements need; the counter then sees those local ops
and collectives. So every number is PER DEVICE, as the reference's are. (A
mode that counted the DTensor op itself would see the global program.)

  * flops            -- matrix products only (``mm``, ``bmm``, ``addmm``,
                        ``baddbmm``; einsum reaches them): 2 * the product's
                        result elements * its contracted size, as
                        ``_dot_flops`` counts a ``dot``.
  * hbm_bytes        -- per op that moves data (every op but views),
                        operand + result bytes, as ``_mover_bytes`` charges.
  * collective bytes -- per collective (``_c10d_functional``), the ring
                        model below on its result bytes and group size.
  * the sequence scans -- each custom op of ``kernels.recurrence`` is one
                        op, charged by a rule of its own (``_scan_flops``):
                        FLOPs the products the reference's scan body
                        counts as dots, times its trips. RWKV-6 forward:
                        ``r . (S + ...)``, 2 B H Dh^2 a step (``k v^T``
                        contracts nothing: XLA makes it a multiply, no
                        dot); backward: its three transposed products
                        with a contraction (``dr``, ``dk``'s ``G v``,
                        ``dv``'s ``G^T k``), 6 B H Dh^2 a step. The
                        RG-LRU's scan has no product. Bytes: the kernel's
                        own reads and writes, operands and results (the
                        backward recomputes its states on chip). Nothing
                        is charged per time step.

Ring traffic model per collective (bytes = full result size r, group n):
  all-reduce          2 * r * (n-1)/n
  all-gather          r * (n-1)/n
  reduce-scatter      r * (n-1)          (operand = n * result)
  all-to-all          r * (n-1)/n
  collective-permute  r

The eager step has no loops with a count: a Python loop runs its body once
per trip, and each trip is counted as it runs, so ``while_trips`` stays
empty. ``OpCounter.rows`` groups the ops by (op, shapes) with the count of
runs as the multiplier (the reference's trip-count multiplier).

The counter also follows the storage that the ops allocate (per rank: the local shards): ``peak_bytes`` is the most that was
live at once, the dry run's ``temp_bytes``.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_PLAIN = (torch.Tensor, torch.nn.Parameter)
# ops that allocate and move nothing
_FREE = {"wait_tensor", "detach", "empty", "empty_strided", "empty_like",
         "lift_fresh", "_local_scalar_dense", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "set_"}


@dataclasses.dataclass
class ModuleCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0          # ring-model link traffic
    collective_result_bytes: float = 0.0   # raw summed result sizes
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    dot_count: float = 0.0
    while_trips: list = dataclasses.field(default_factory=list)
    precision: str = "f32"                 # the peak the products run at

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_result_bytes": self.collective_result_bytes,
                "collective_counts": dict(self.collective_counts),
                "dot_count": self.dot_count,
                "while_trips": list(self.while_trips)}


def _collective_traffic(op: str, result_bytes: int, n: int) -> float:
    n = max(n, 2)
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if op == "collective-permute":
        return float(result_bytes)
    return float(result_bytes) * (n - 1) / n     # all-gather / all-to-all


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _shape(t: torch.Tensor) -> str:
    dt = str(t.dtype).replace("torch.", "")
    return f"{dt}[{','.join(str(d) for d in t.shape)}]"


def _dot_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    # [.., M, K] x [.., K, N]: 2 * (batch * M * N) * K
    return 2.0 * a.numel() * b.shape[-1]


_SCANS = {"rglru_scan", "rglru_scan_backward", "wkv6_scan",
          "wkv6_scan_backward"}


def _scan_flops(name: str, args) -> float:
    """FLOPs of one scan op."""
    if not name.startswith("wkv6"):
        return 0.0
    b, s, h, d = args[0].shape
    return (2.0 if name == "wkv6_scan" else 6.0) * b * s * h * d * d


def _group_size(name: str, args) -> int:
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    group = args[-1]
    if not isinstance(group, str):
        return group.size()
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size()


class OpCounter(TorchDispatchMode):
    """Counts what each op of the ranks' local programs does (see the
    module docstring). ``cost()`` is the ``ModuleCost``; ``rows()`` the
    per-(op, shapes) breakdown; ``peak_bytes`` the allocation peak."""

    def __init__(self):
        super().__init__()
        self._rows = collections.OrderedDict()   # key -> [bytes, flops, n]
        self._counts = defaultdict(float)
        self._traffic = defaultdict(float)
        self._flops_by_dtype = defaultdict(float)
        self.collective_bytes = 0.0
        self.collective_result_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storage = {}        # storage id -> [nbytes, live tensors]
        self._seen = set()        # ids of tensors already followed

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "FakeTensor" for t in types):
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shapes to learn the result's metadata: no
            # device runs that
            return func(*args, **kwargs)
        if any(t not in _PLAIN for t in types):
            # DTensor runs it on the shards (and a collective's result
            # wrapper waits, then reruns it on the plain result): the
            # plain ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out) -> None:
        outs = list(_tensors(out))
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        view = getattr(func, "is_view", False)
        name = func.overloadpacket.__name__
        inputs = {id(t) for t in ins}
        # a view or an in-place result holds no new storage: it is
        # followed only as another holder of a storage followed.
        # DTensor's sharding propagation makes empty tensors of the global
        # shapes (``empty_strided``) to learn an op's result: they are no
        # rank's
        new = not view and name != "empty_strided"
        for t in outs:
            self._follow(t, new=new and id(t) not in inputs)
        if name in _FREE or view:
            return
        flops = 0.0
        if name in _SCANS:
            flops = _scan_flops(name, args)
            self._flops_by_dtype[args[0].dtype] += flops
        elif name in _DOTS:
            flops = _dot_flops(name, args)
            dt = args[1].dtype if name in ("addmm", "baddbmm") \
                else args[0].dtype
            self._flops_by_dtype[dt] += flops
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in
                                                     outs)
        op = name
        if name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            rb = sum(_nbytes(t) for t in outs)
            self._counts[op] += 1
            self.collective_result_bytes += rb
            traffic = _collective_traffic(op, rb, _group_size(name, args))
            self.collective_bytes += traffic
            self._traffic[op] += traffic
        key = (op, tuple(_shape(t) for t in ins), tuple(
            _shape(t) for t in outs))
        row = self._rows.get(key)
        if row is None:
            self._rows[key] = [float(nbytes), flops, 1]
        else:
            row[0] += nbytes
            row[1] += flops
            row[2] += 1

    # ------------------------------------------------------------ memory
    def _follow(self, t: torch.Tensor, new: bool) -> None:
        if id(t) in self._seen:
            return
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        entry = self._storage.get(key)
        if entry is None:
            if not new:          # a view of storage the step did not make
                return
            entry = self._storage[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key, tid) -> None:
        self._seen.discard(tid)
        entry = self._storage.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storage[key]

    # ------------------------------------------------------------ results
    def collective_bytes_by_kind(self) -> dict:
        """Ring-model link bytes per collective kind."""
        return dict(self._traffic)

    def rows(self) -> list:
        """[(bytes, flops, mult, op, description)]: one row per (op,
        operand shapes, result shapes), summed over its ``mult`` runs. The
        rows add up to ``cost()``'s ``hbm_bytes`` and ``flops``."""
        return [(b, f, n, key[0],
                 f"{key[0]}({', '.join(key[1])}) -> {', '.join(key[2])}")
                for key, (b, f, n) in self._rows.items()]

    def cost(self) -> ModuleCost:
        c = ModuleCost()
        for key, (b, f, n) in self._rows.items():
            c.hbm_bytes += b
            c.flops += f
            if key[0] in _DOTS:
                c.dot_count += n
        c.collective_bytes = self.collective_bytes
        c.collective_result_bytes = self.collective_result_bytes
        c.collective_counts.update(self._counts)
        if self._flops_by_dtype:
            dt = max(self._flops_by_dtype, key=self._flops_by_dtype.get)
            c.precision = {torch.bfloat16: "bf16", torch.float16: "bf16",
                           torch.int8: "int8"}.get(dt, "f32")
        return c


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an ``OpCounter``: (its result, the
    per-device ``ModuleCost``, the counter)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost(), counter
