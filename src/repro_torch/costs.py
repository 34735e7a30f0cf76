"""A per-chip cost counter for eager PyTorch: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference walks the compiled HLO of a step; an eager step has no such
program, so the port counts the ops as they run.  :class:`CostCounter` is
a ``TorchDispatchMode`` that sees every op on a local tensor (a plain
tensor, or the local shard of a ``DTensor``) and adds up:

* ``flops`` of the matmul-class ops (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, the convolutions and the attention ops), by
  ``torch.utils.flop_counter``'s formulas;
* ``bytes_accessed``: the operand and result bytes of every op, since
  each eager op is a kernel boundary (views and allocations move none; an
  in-place op reads and writes its target, an indexed write moves only the
  rows it writes);
* ``bytes_fused``: the same without the ops a fusing compiler folds into
  their neighbours (pointwise ops, reductions, casts, concatenation,
  padding, reversal: the reference's ``_ELEMENTWISE``), so the roofline's
  memory term keeps the reference's meaning;
* ``coll_breakdown``: the operand bytes of each collective
  (``_c10d_functional`` and DTensor's all-to-all), by kind;
* ``peak_bytes``: the most bytes of local storage alive at once, counting
  the storages registered with :meth:`CostCounter.track` (the step's
  arguments) and every storage an op made since.

It counts **per chip**.  An op on DTensors is handed back to DTensor
(``NotImplemented``), which runs it as ops on the local shards; those the
counter sees and counts.  DTensor's own bookkeeping is not counted: the
ops it runs on fake tensors at the global shape to infer an output's
layout, and, with ``device`` given, any op that touches no tensor on that
device (it computes shard offsets with small CPU tensors, the first time
it meets each layout: count a CPU step after a warm-up run).  Kernels that
reach the card through ctypes bypass the dispatcher, so each such wrapper
calls :func:`record` with its work (K5, ``kernels.flash_attention``).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_COLL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
# no kernel of their own: a collective's completion, autograd bookkeeping
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd", "empty",
               "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
# writes into rows of their first argument: the traffic is the rows
_INDEXED_WRITE = {"index_copy_", "index_put_", "index_add_", "scatter_",
                  "scatter_add_", "scatter_reduce_"}
# what a fusing compiler folds into neighbouring kernels, besides the ops
# tagged pointwise or reduction (the reference's _ELEMENTWISE)
_FUSIBLE = {"_to_copy", "cat", "constant_pad_nd", "flip"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors in nested lists, tuples and dicts (an op's arguments
    or results), in no particular order."""
    out, stack = [], [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return out


def _in_propagation() -> bool:
    """Whether the op runs inside DTensor's layout inference (under a
    FakeTensorMode, at the global shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


class CostCounter(TorchDispatchMode):
    """Enter it around a step; read ``flops``, ``bytes_accessed``,
    ``bytes_fused``, ``coll_breakdown``, ``coll_bytes`` and ``peak_bytes``
    after."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.flops = 0
        self.bytes_accessed = 0
        self.bytes_fused = 0
        self.coll_breakdown = {k: 0 for k in COLLECTIVES}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}

    @property
    def coll_bytes(self) -> int:
        return sum(self.coll_breakdown.values())

    # ------------------------------------------------------------ memory
    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage alive until it is freed, at ``t``'s own
        bytes (a collective's meta kernel returns a slice of a larger
        buffer; the card's returns a tensor of its own)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = _nbytes(t)
        self.live_bytes += _nbytes(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local shards) as alive from now on."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    # -------------------------------------------------------------- work
    def add(self, flops: int = 0, n_bytes: int = 0, *,
            fusible: bool = False) -> None:
        self.flops += flops
        self.bytes_accessed += n_bytes
        if not fusible:
            self.bytes_fused += n_bytes

    def _traffic(self, func, args, kwargs, out) -> int:
        name = func._overloadpacket.__name__
        schema = func._schema
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        n = 0
        for arg_name, v in named.items():
            size = sum(_nbytes(t) for t in _tensors(v))
            if arg_name not in written:
                n += size
            elif name not in _INDEXED_WRITE:
                n += size if name == "copy_" else 2 * size
        if name in _INDEXED_WRITE:       # the rows written, once more
            n += sum(_nbytes(t) for k in ("source", "values", "src")
                     for t in _tensors(named.get(k)))
        if not any(r.alias_info is not None for r in schema.returns):
            n += sum(_nbytes(t) for t in _tensors(out))
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented          # DTensor runs it on local shards
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if _in_propagation() or (self.device is not None and not any(
                t.device.type == self.device for t in flat + outs)):
            return out
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            if not func.is_view:
                for t in outs:
                    self._hold(t)
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _COLL_KIND.get(name) if func.namespace in (
            "_c10d_functional", "_dtensor", "c10d") else None
        if kind is not None:
            self.coll_breakdown[kind] += sum(_nbytes(t) for t in flat)
        tags = func.tags
        self.add(n_bytes=self._traffic(func, args, kwargs, out),
                 fusible=(torch.Tag.pointwise in tags
                          or torch.Tag.reduction in tags
                          or name in _FUSIBLE))
        for t in outs:
            self._hold(t)
        return out


def record(flops: int, n_bytes: int) -> None:
    """Add the work of a kernel launched outside the dispatcher (through
    ctypes) to every counter on the dispatch-mode stack."""
    for c in _get_current_dispatch_mode_stack():
        if isinstance(c, CostCounter):
            c.add(flops, n_bytes)


def attention_flops(B: int, H: int, Sq: int, Sk: int, D: int, *,
                    causal: bool, window=None, v_dim=None) -> int:
    """2·B·H·(D + D_v) per (query, key) pair an attention core scores (QKᵀ
    at the query and key width D, PV at the value width D_v, which is D
    when ``v_dim`` is None): Sq·Sk pairs, the causal triangle's S(S+1)/2
    when causal, fewer under a sliding window."""
    if not causal:
        pairs = Sq * Sk
    else:
        w = Sq if window is None else min(window, Sq)
        # row q sees min(q + 1, w) keys
        pairs = w * (w + 1) // 2 + (Sq - w) * w
    return 2 * B * H * (D + (D if v_dim is None else v_dim)) * pairs


__all__ = ["COLLECTIVES", "CostCounter", "attention_flops", "record"]
