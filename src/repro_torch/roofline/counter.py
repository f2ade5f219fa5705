"""Counts of one eager step, op by op — the port's counterpart of the JAX
package's ``repro/roofline/hlo_stats.py``.

Eager PyTorch has no HLO to read. :class:`OpCounter` is a
``TorchDispatchMode``: every aten op the step runs passes through it,
and it counts the op where it runs — on the **local** shard of a
``DTensor`` (it hands DTensor ops back to DTensor and sees the local ops
DTensor issues), so each count is one device's. It counts

* **FLOPs** of contractions only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions and their backward), by
  ``torch.utils.flop_counter``'s formulas on the local shapes, as
  ``hlo_stats`` counts ``dot``/``convolution`` — elementwise work is
  noise at LM scale;
* **bytes** read and written by every op that is not a view: each tensor
  operand once and each result once. ``hlo_stats`` leaves elementwise
  ops out because a TPU compile fuses them into their neighbours; eager
  PyTorch fuses nothing, so every op's operands and results cross HBM
  and all of them are counted: this is the traffic the eager step pays;
* **attention-score bytes** (``bytes_scores_class``: tensors with two
  sequence-sized dims, by ``hlo_stats._is_scores_class``'s rule), the
  traffic a flash kernel keeps on chip, and bytes by aten op;
* **collectives** DTensor issues (``_c10d_functional``): kind, bytes,
  and the group's ranks, priced by :func:`.analysis.ring_seconds`. The
  bytes are the result's, as ``analysis.parse_collectives`` reads them
  off each collective's HLO result shape in the JAX package: the
  gathered tensor of an all-gather, the scattered shard of a
  reduce-scatter (whose ring time is priced on its operand);
* the **peak of live bytes** of the storages the step's ops create, from
  the moment an op returns a new storage to the moment the storage is
  freed (a weak reference to the storage).

``hlo_stats`` has to recover loop trip counts because XLA counts a
``while`` body once. An eager step runs every layer's ops, so every
iteration is counted where it runs. An op none of whose tensors lies on
the counted device type (the CPU RNG state ``torch.utils.checkpoint``
clones when it recomputes a layer on the card, for one) is host work and
is not counted; neither are the fake-tensor ops DTensor runs to
propagate shapes.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, Iterable, List, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from .analysis import ring_seconds

__all__ = ["CountStats", "OpCounter", "count"]

aten = torch.ops.aten

#: contractions whose FLOPs are counted (``hlo_stats``' dot/convolution)
_CONTRACTIONS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm,
                 aten.convolution, aten._convolution,
                 aten.convolution_backward}

#: ops that move no data although their schema does not say "view"
_FREE = {"aten._unsafe_view", "aten.empty", "aten.empty_strided",
         "aten.empty_like", "aten.lift_fresh", "aten.detach",
         "aten.alias", "aten._local_scalar_dense"}

#: ``_c10d_functional`` op → (collective kind, which bytes price its
#: ring time); the bytes counted are always the result's
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "out"),
    "all_reduce_": ("all-reduce", "out"),
    "all_reduce_coalesced": ("all-reduce", "out"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "shard_dim_alltoall": ("all-to-all", "out"),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _is_scores_class(shape, seq_dims=None) -> bool:
    """Attention-score-shaped: ≥2 dims that are sequence-sized. With
    ``seq_dims`` (e.g. {4096, 512, 256}) membership is exact; fallback is
    ≥2 dims ≥2048."""
    if seq_dims is not None:
        return sum(1 for d in shape if d in seq_dims) >= 2
    return sum(1 for d in shape if d >= 2048) >= 2


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class CountStats:
    """One step's counts on one device (``hlo_stats.ModuleStats``)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: int = 0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_opcode: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: traffic of attention-score-class tensors: the bytes a flash
    #: attention kernel keeps in shared memory and registers
    bytes_scores_class: float = 0.0
    #: peak of the live bytes of the storages the step created
    peak_live_bytes: int = 0


class OpCounter(TorchDispatchMode):
    """Count the ops run under it on tensors of ``device_type`` (``"meta"``
    for a dry run, ``"cuda"`` on the card). ``seq_dims`` makes the
    scores-class rule exact. Read :attr:`stats` after the ``with``."""

    def __init__(self, device_type: str, *, seq_dims: Optional[Iterable[int]]
                 = None):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.device_type = device_type
        self.seq_dims = set(seq_dims) if seq_dims is not None else None
        self.stats = CountStats()
        self._lock = threading.Lock()
        self._live = 0
        self._tracked = weakref.WeakSet()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented           # DTensor issues the local ops
        out = func(*args, **kwargs)
        if not any(type(m).__name__ == "FakeTensorMode"
                   for m in _get_current_dispatch_mode_stack()):
            self._count(func, args, kwargs, out)
        return out

    # -- counting ------------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == self.device_type for t in ins + outs):
            return
        name = f"{func.namespace}.{func._opname}"
        st = self.stats
        if func.overloadpacket in _CONTRACTIONS:
            from torch.utils.flop_counter import flop_registry
            f = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            st.flops += f
            st.flops_by_op[name] = st.flops_by_op.get(name, 0.0) + f
        if func.namespace in _COLLECTIVE_NAMESPACES and \
                func._opname in _COLLECTIVES:
            self._collective(func._opname, args, ins, outs)
        if func.is_view or name in _FREE or \
                func.namespace in _COLLECTIVE_NAMESPACES and \
                func._opname not in _COLLECTIVES:
            return
        nbytes = sum(_nbytes(t) for t in ins + outs)
        st.bytes_accessed += nbytes
        st.bytes_by_opcode[name] = st.bytes_by_opcode.get(name, 0.0) + nbytes
        st.bytes_scores_class += sum(
            _nbytes(t) for t in ins + outs
            if _is_scores_class(t.shape, self.seq_dims))
        for t in outs:
            self._track(t)

    def _collective(self, opname: str, args, ins, outs) -> None:
        from torch.distributed import get_process_group_ranks
        from torch.distributed.distributed_c10d import _resolve_process_group
        kind, side = _COLLECTIVES[opname]
        group = next(a for a in reversed(args) if isinstance(a, str))
        ranks = get_process_group_ranks(_resolve_process_group(group))
        nbytes = sum(_nbytes(t) for t in outs)
        priced = sum(_nbytes(t) for t in ins) if side == "in" else nbytes
        st = self.stats
        st.collective_bytes[kind] = st.collective_bytes.get(kind, 0) + nbytes
        st.collective_seconds[kind] = st.collective_seconds.get(kind, 0.0) \
            + ring_seconds(kind, priced, ranks)
        st.collective_count += 1

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        with self._lock:
            if storage in self._tracked:
                return
            self._tracked.add(storage)
            n = storage.nbytes()
            self._live += n
            if self._live > self.stats.peak_live_bytes:
                self.stats.peak_live_bytes = self._live
        weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        with self._lock:
            self._live -= n


def count(fn, device_type: str, *, seq_dims=None):
    """``(fn(), CountStats)`` of one call of ``fn`` under an
    :class:`OpCounter`."""
    with OpCounter(device_type, seq_dims=seq_dims) as counter:
        result = fn()
    return result, counter.stats
