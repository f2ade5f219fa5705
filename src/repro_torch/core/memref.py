"""Device-resident memory references — the paper's ``mem_ref<T>`` (§3.5).

A :class:`DeviceRef` represents data living on an accelerator device. It is
the *currency* of the runtime: kernel actors accept and emit refs natively,
pipeline stages forward them so intermediate results never round-trip
through host memory, and pools route work toward the device a ref already
lives on.

PyTorch adaptation: a kernel launch returns as soon as it is enqueued on
a CUDA stream, and each :class:`~repro_torch.core.manager.Device` owns one
stream on which every kernel actor bound to it launches. On one device
with one stream, **stream order is the completion event**: stage *n+1* is
enqueued behind stage *n* on the same stream, so it may be launched before
stage *n* has finished — the paper's OpenCL-event chaining (Listing 4).
A ref remembers the stream it was produced on; reading it on any other
stream (a host read-back on the caller's stream, a kernel actor of
another device) makes that stream ``wait_stream`` the producer and
``record_stream``\\ s the tensor so the allocator cannot reuse its memory
early. That rule lives in one place, :meth:`DeviceRef.array`.

Like the paper's reference type, a ``DeviceRef`` carries element type,
shape, and **access rights** ("r", "w", "rw") which are enforced: reading
a write-only ref or donating a read-only ref raises
:class:`~repro_torch.core.errors.AccessViolation`. For distribution the
paper offers two options — (a) prohibit serialization, (b) serialize
through an explicit host copy. Both are implemented: a device-resident ref
refuses to pickle, while :meth:`DeviceRef.spill` moves the payload to
(pinned) host memory at an explicit boundary, after which the ref pickles
and can be :meth:`~DeviceRef.unspill`\\ ed on the receiving side.

Every ref is accounted in the process-wide :class:`RefRegistry`: per-device
live bytes (keyed by ``torch.device``, with a high watermark feeding
placement policies) plus the host-transfer counters the zero-copy tests
assert on.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import trace
from ..analysis.runtime import make_rlock
from .errors import AccessViolation
from .signature import dtype_name, to_torch_dtype

__all__ = [
    "DeviceRef",
    "RefRegistry",
    "registry",
    "as_device_array",
    "default_device",
    "to_numpy",
    "live_ref_count",
    "transfer_count",
    "reset_transfer_stats",
    "memory_stats",
    "payload_device",
    "payload_nbytes",
    "tree_wrap",
    "tree_unwrap",
    "tree_release",
]

_ACCESS_MODES = ("r", "w", "rw")


def default_device() -> torch.device:
    """The device an entry point binds when the caller names none: the
    current CUDA device. Without a CUDA device this raises
    :class:`LookupError` — the CPU is used only when asked for."""
    if not torch.cuda.is_available():
        raise LookupError("no CUDA device is available; pass device='cpu' "
                          "(or ActorSystem(device='cpu')) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _producer_stream(t: torch.Tensor) -> Optional["torch.cuda.Stream"]:
    return torch.cuda.current_stream(t.device) if t.is_cuda else None


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor as a numpy array. bfloat16, which numpy
    lacks, is widened to float32 (exactly)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned memory for a CUDA tensor (the copy is
    awaited), a plain clone for a CPU tensor."""
    if not t.is_cuda:
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


class RefRegistry:
    """Process-wide accounting of live :class:`DeviceRef`\\ s.

    Tracks the live-ref count (leak checks), per-device live bytes with a
    high watermark (``DeviceManager`` exposes these to the pool's
    least-loaded placement), and the device↔host traffic counters:

    * ``transfers``  — explicit ``to_value()`` read-backs
    * ``readbacks``  — kernel-actor value-semantics outputs
    * ``spills`` / ``unspills`` — explicit serialization boundaries
    """

    def __init__(self):
        # reentrant: DeviceRef.__del__ releases through the registry, so
        # a GC pass triggered inside a locked registry method re-enters
        # this lock on the same thread (see analysis/ORDER.md, rank 20)
        self._lock = make_rlock("RefRegistry")
        self._count = 0
        self._bytes: Dict[Any, int] = {}
        self._peak: Dict[Any, int] = {}
        self._pool_refs: list = []      # weakrefs to live PagePools
        self.transfers = 0
        self.readbacks = 0
        self.spills = 0
        self.unspills = 0
        trace.reads(self, RefRegistry._traffic)

    def _traffic(self) -> Dict[str, int]:
        """The traffic counters as ``trace.counters()`` names them."""
        with self._lock:
            return {"memref.transfers": self.transfers,
                    "memref.readbacks": self.readbacks,
                    "memref.spills": self.spills,
                    "memref.unspills": self.unspills}

    # -- ref lifecycle (called by DeviceRef) ---------------------------------
    def on_create(self, device, nbytes: int, resident: bool) -> None:
        with self._lock:
            self._count += 1
            if resident:
                self._add_bytes(device, nbytes)

    def on_resident(self, device, nbytes: int) -> None:
        with self._lock:
            self._add_bytes(device, nbytes)

    def on_evict(self, device, nbytes: int) -> None:
        with self._lock:
            self._bytes[device] = self._bytes.get(device, 0) - nbytes

    def on_retire(self, device, nbytes: int, resident: bool) -> None:
        with self._lock:
            self._count -= 1
            if resident:
                self._bytes[device] = self._bytes.get(device, 0) - nbytes

    def _add_bytes(self, device, nbytes: int) -> None:
        b = self._bytes.get(device, 0) + nbytes
        self._bytes[device] = b
        if b > self._peak.get(device, 0):
            self._peak[device] = b

    # -- traffic counters -----------------------------------------------------
    def count_transfer(self) -> None:
        with self._lock:
            self.transfers += 1

    def count_readback(self) -> None:
        with self._lock:
            self.readbacks += 1

    def count_spill(self) -> None:
        with self._lock:
            self.spills += 1

    def count_unspill(self) -> None:
        with self._lock:
            self.unspills += 1

    # -- page pools (repro_torch.serve.kvpool) --------------------------
    def register_pool(self, pool) -> None:
        """Track a page pool (weakly) so page pressure is reported next
        to the byte watermarks in :func:`memory_stats`."""
        with self._lock:
            self._pool_refs.append(weakref.ref(pool))
            self._pool_refs = [r for r in self._pool_refs
                               if r() is not None]

    def _live_pools(self, device=None) -> list:
        with self._lock:
            pools = [r() for r in self._pool_refs]
        pools = [p for p in pools if p is not None]
        if device is None:
            return pools
        return [p for p in pools if p.device == device]

    def page_stats(self, device=None) -> dict:
        """Aggregated page-pool pressure (optionally one device's):
        capacity, live/free/shared pages, peak, and the internal
        fragmentation ratio (unused slots inside allocated pages)."""
        agg = {"pages_total": 0, "pages_live": 0, "pages_free": 0,
               "pages_shared": 0, "peak_pages": 0}
        used = slots = 0
        for pool in self._live_pools(device):
            s = pool.stats()          # pool lock only; never ours
            for k in agg:
                agg[k] += s[k]
            used += s["used_slots"]
            slots += s["page_slots"]
        agg["fragmentation"] = (1.0 - used / slots) if slots else 0.0
        return agg

    # -- queries ------------------------------------------------------
    def live_count(self) -> int:
        return self._count

    def live_bytes(self, device=None) -> int:
        with self._lock:
            if device is None:
                return sum(self._bytes.values())
            return self._bytes.get(device, 0)

    def peak_bytes(self, device=None) -> int:
        with self._lock:
            if device is None:
                return sum(self._peak.values())
            return self._peak.get(device, 0)

    def stats(self) -> dict:
        with self._lock:
            base = {
                "live_refs": self._count,
                "live_bytes": sum(self._bytes.values()),
                "peak_bytes": sum(self._peak.values()),
                "transfers": self.transfers,
                "readbacks": self.readbacks,
                "spills": self.spills,
                "unspills": self.unspills,
            }
        pages = self.page_stats()       # own locking (pool locks)
        base["pages_total"] = pages["pages_total"]
        base["pages_free"] = pages["pages_free"]
        base["pages_shared"] = pages["pages_shared"]
        base["fragmentation"] = pages["fragmentation"]
        return base

    def reset_traffic(self) -> None:
        """Zero the host-traffic counters (not the live accounting)."""
        with self._lock:
            self.transfers = 0
            self.readbacks = 0
            self.spills = 0
            self.unspills = 0


#: the process-wide registry every DeviceRef reports to
registry = RefRegistry()


def live_ref_count() -> int:
    """Number of un-released DeviceRefs (used by tests/leak checks)."""
    return registry.live_count()


def transfer_count() -> int:
    """Explicit ``DeviceRef.to_value()`` device→host copies so far."""
    return registry.transfers


def reset_transfer_stats() -> None:
    """Zero the host-traffic counters (transfers/readbacks/spills)."""
    registry.reset_traffic()


def memory_stats() -> dict:
    """Registry snapshot: live refs/bytes, watermark, traffic counters."""
    return registry.stats()


def payload_device(payload) -> Optional[torch.device]:
    """The device the first :class:`DeviceRef` in ``payload`` lives on, or
    ``None`` — the placement hint pools route by."""
    for v in payload:
        if isinstance(v, DeviceRef) and v.device is not None and not v.is_spilled:
            return v.device
    return None


def payload_nbytes(payload) -> int:
    """Total array bytes a payload would move — the size term
    :mod:`repro_torch.core.placement`'s wire-cost model prices hops by.
    Walks tuples, lists and dicts and counts DeviceRefs, tensors and
    numpy arrays; opaque Python objects count zero."""
    total = 0
    stack = [payload]
    while stack:
        v = stack.pop()
        if isinstance(v, DeviceRef):
            total += v.nbytes
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, torch.Tensor):
            total += int(v.nbytes)
        elif isinstance(v, np.ndarray):
            total += int(v.nbytes)
    return total


class DeviceRef:
    """A typed handle to device-resident data (``mem_ref<T>``).

    Attributes mirror the paper's description: "a reference type includes
    type information about the data it references in addition to the amount
    of bytes it refers to and memory access rights."

    Lifecycle states: ``live`` (device-resident) → ``spilled`` (host copy,
    device buffer dropped; picklable) ↔ ``live``; terminal states are
    ``donated`` (buffer ownership transferred into a kernel) and
    ``released``.
    """

    __slots__ = ("_array", "_host", "_stream", "dtype", "shape", "access",
                 "device", "_state", "__weakref__")

    def __init__(self, array: torch.Tensor, access: str = "rw"):
        if access not in _ACCESS_MODES:
            raise ValueError("access must be 'r', 'w' or 'rw'")
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"DeviceRef wraps a torch.Tensor, got "
                            f"{type(array).__name__}")
        self._array = array
        self._host = None
        #: the stream whose order completes the producing work (CUDA only)
        self._stream = _producer_stream(array)
        self.dtype = array.dtype
        self.shape = tuple(array.shape)
        self.access = access
        self.device = array.device
        self._state = "live"
        registry.on_create(self.device, self.nbytes, resident=True)

    @classmethod
    def put(cls, value, device=None, dtype=None, access: str = "rw") -> "DeviceRef":
        """Transfer a host value to ``device`` (default: the current CUDA
        device) and wrap it (the paper's first-actor-in-the-chain input
        transfer, made explicit)."""
        return cls(as_device_array(value, device=device, dtype=dtype),
                   access=access)

    # -- properties ---------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(self.dtype.itemsize * math.prod(self.shape))

    @property
    def readable(self) -> bool:
        return "r" in self.access

    @property
    def writable(self) -> bool:
        return "w" in self.access

    @property
    def is_spilled(self) -> bool:
        return self._state == "spilled"

    def _check_usable(self) -> None:
        if self._state == "released":
            raise RuntimeError("DeviceRef used after release")
        if self._state == "donated":
            raise RuntimeError(
                "DeviceRef used after donation: the buffer was donated to a "
                "kernel and its ownership transferred (donate-after-use)")

    def _synced(self) -> torch.Tensor:
        """The tensor, ordered after its producer on the current stream."""
        t = self._array
        if self._stream is not None:
            cur = torch.cuda.current_stream(t.device)
            if cur != self._stream:
                cur.wait_stream(self._stream)
                t.record_stream(cur)
        return t

    @property
    def array(self) -> torch.Tensor:
        """The underlying (possibly still-computing) device tensor, safe
        to use on the current stream."""
        self._check_usable()
        if self._state == "spilled":
            raise RuntimeError(
                "DeviceRef is spilled to host memory; call unspill() first")
        if not self.readable:
            raise AccessViolation(
                f"DeviceRef has access rights {self.access!r}; reading "
                "requires 'r'")
        return self._synced()

    def is_ready(self) -> bool:
        """True once the producing work has completed on the device."""
        if self._state != "live" or self._stream is None:
            return True
        return bool(self._stream.query())

    # -- access rights ------------------------------------------------------
    def restrict(self, access: str) -> "DeviceRef":
        """A narrowed-rights view of the same device buffer (paper §3.5).

        Rights may only shrink (``rw`` → ``r``); widening raises
        :class:`AccessViolation`. The view is an independent ref — release
        it like any other (accounting counts its bytes separately).
        """
        if access not in _ACCESS_MODES:
            raise ValueError("access must be 'r', 'w' or 'rw'")
        if not set(access) <= set(self.access):
            raise AccessViolation(
                f"cannot widen access rights {self.access!r} -> {access!r}")
        self._check_usable()
        if self._state == "spilled":
            raise RuntimeError("cannot derive a view of a spilled DeviceRef")
        view = DeviceRef(self._array, access=access)
        view._stream = self._stream
        return view

    # -- data movement ------------------------------------------------------
    def to_value(self) -> np.ndarray:
        """Explicit device→host copy (the paper's read-back at pipeline end).

        Counted in :func:`transfer_count` — the zero-copy pipeline tests
        assert this stays flat across stage hops.
        """
        self._check_usable()
        if not self.readable:
            raise AccessViolation(
                f"DeviceRef has access rights {self.access!r}; to_value() "
                "requires 'r'")
        if self._state == "spilled":
            return to_numpy(self._host).copy()
        registry.count_transfer()
        return to_numpy(self._synced())

    def block_until_ready(self) -> "DeviceRef":
        self._check_usable()
        if self._state == "live" and self._stream is not None:
            self._stream.synchronize()
        return self

    # -- spill / unspill (paper §3.5 distribution option (b)) ----------------
    def spill(self) -> "DeviceRef":
        """Serialize to (pinned) host memory and drop the device buffer.

        This is the *explicit* stage boundary for distribution: a spilled
        ref pickles (see ``__reduce__``) and stops counting against the
        device's live bytes. Inverse of :meth:`unspill`. Requires read
        rights — spilling serializes the contents, so a write-only view
        must not be able to exfiltrate data its rights forbid reading.
        """
        self._check_usable()
        if self._state == "spilled":
            return self
        if not self.readable:
            raise AccessViolation(
                f"DeviceRef has access rights {self.access!r}; spill() "
                "serializes the contents and requires 'r'")
        self._host = _to_host(self._synced())
        self._array = None
        self._stream = None
        self._state = "spilled"
        registry.count_spill()
        registry.on_evict(self.device, self.nbytes)
        return self

    def spill_copy(self) -> "DeviceRef":
        """A spilled **clone** for the wire: serializes the contents into a
        new picklable host-side ref, leaving this ref device-resident.
        Counts one spill. Requires read rights, like :meth:`spill`."""
        self._check_usable()
        if not self.readable:
            raise AccessViolation(
                f"DeviceRef has access rights {self.access!r}; spill_copy() "
                "serializes the contents and requires 'r'")
        if self._state == "spilled":
            host = self._host.clone()
        else:
            host = _to_host(self._synced())
        registry.count_spill()
        return _rebuild_spilled(host, self.dtype, self.shape, self.access)

    def unspill(self, device=None) -> "DeviceRef":
        """Move a spilled payload back onto ``device`` (default: where it
        lived before, else the current CUDA device). Accepts a
        ``torch.device``, a device string, or the runtime's ``Device``
        wrapper."""
        if self._state != "spilled":
            self._check_usable()
            return self
        device = getattr(device, "torch_device", device)
        target = torch.device(device) if device is not None else \
            (self.device or default_device())
        self._array = self._host.to(target, non_blocking=True)
        self._stream = _producer_stream(self._array)
        self._host = None
        self.device = self._array.device
        self._state = "live"
        registry.count_unspill()
        registry.on_resident(self.device, self.nbytes)
        return self

    # -- consumption ------------------------------------------------------
    def donate(self) -> torch.Tensor:
        """Consume the ref for buffer donation: returns the tensor and marks
        the ref dead so a kernel may update the buffer in place (handing a
        read-write ``cl_mem`` to a kernel). Requires write rights; any later
        use raises a donate-after-use error."""
        self._check_usable()
        if self._state == "spilled":
            raise RuntimeError(
                "cannot donate a spilled DeviceRef; unspill() first")
        if not self.writable:
            raise AccessViolation(
                f"DeviceRef has access rights {self.access!r}; donation "
                "requires 'w'")
        arr = self._synced()
        self._array = None
        self._stream = None
        self._state = "donated"
        registry.on_retire(self.device, self.nbytes, resident=True)
        return arr

    def release(self) -> None:
        """Drop the buffer (paper: "dropping a reference argument simply
        releases its memory on the device"). Idempotent."""
        if self._state in ("released", "donated"):
            return
        resident = self._state == "live"
        registry.on_retire(self.device, self.nbytes, resident=resident)
        self._array = None
        self._host = None
        self._stream = None
        self._state = "released"

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.release()
        except Exception:
            pass  # lint: finalizers must never raise

    # -- distribution policy -------------------------------------------------
    def __reduce__(self):
        # Paper §3.5: option (a) — a device-resident ref refuses to
        # serialize, so sending one over the network raises instead of
        # silently copying; option (b) — after an *explicit* spill() the
        # host payload travels and unspill() restores device residency on
        # the receiving node.
        if self._state == "spilled":
            return (_rebuild_spilled,
                    (self._host, self.dtype, self.shape, self.access))
        raise TypeError(
            "DeviceRef is bound to local device memory and cannot be "
            "serialized; call .spill() for explicit host serialization or "
            ".to_value() for an explicit host copy")

    def __repr__(self):
        """Diagnostic form: dtype/shape, access rights, lifecycle state,
        byte size, and where the payload lives. Examples::

            DeviceRef<float32>[16][rw, live/ready, 64B @ cuda:0]
            DeviceRef<float32>[16][r, spilled, 64B @ host]
            DeviceRef<float32>[16][rw, released]
        """
        head = f"DeviceRef<{dtype_name(self.dtype)}>{list(self.shape)}"
        if self._state == "live":
            phase = "ready" if self.is_ready() else "pending"
            loc = str(self.device) if self.device is not None else "?"
            return f"{head}[{self.access}, live/{phase}, {self.nbytes}B @ {loc}]"
        if self._state == "spilled":
            return f"{head}[{self.access}, spilled, {self.nbytes}B @ host]"
        return f"{head}[{self.access}, {self._state}]"


def _rebuild_spilled(host, dtype, shape, access) -> DeviceRef:
    """Unpickle target: reconstruct a spilled ref (host payload only)."""
    ref = DeviceRef.__new__(DeviceRef)
    ref._array = None
    ref._host = host
    ref._stream = None
    ref.dtype = dtype
    ref.shape = tuple(shape)
    ref.access = access
    ref.device = None
    ref._state = "spilled"
    registry.on_create(None, ref.nbytes, resident=False)
    return ref


# ----------------------------------------------------------------------------
# pytree helpers — per-request state refs
# ----------------------------------------------------------------------------
def tree_wrap(tree, device=None, access: str = "rw", created=None):
    """Wrap every array leaf of a pytree as a :class:`DeviceRef`.

    Leaves that are already refs (and ``None``) pass through unchanged;
    host values are transferred to ``device`` first.

    ``created`` (a list, optional) collects every ref this call creates
    *as it is created* — callers that must release on a mid-tree wrapping
    failure (one bad leaf after several good ones) release the partial
    set instead of leaking it.
    """
    # accept the runtime's Device wrapper as well as a bare torch.device
    device = getattr(device, "torch_device", device)

    def wrap(leaf):
        if leaf is None or isinstance(leaf, DeviceRef):
            return leaf
        ref = DeviceRef(as_device_array(leaf, device=device), access=access)
        if created is not None:
            created.append(ref)
        return ref

    return pytree.tree_map(wrap, tree)


def tree_unwrap(tree):
    """The inverse view: every :class:`DeviceRef` leaf replaced by its
    (possibly still-computing) device tensor; other leaves pass through."""
    return pytree.tree_map(
        lambda l: l.array if isinstance(l, DeviceRef) else l, tree,
        is_leaf=lambda l: isinstance(l, DeviceRef))


def tree_release(tree) -> int:
    """Release every ref leaf in ``tree`` (idempotent); returns how many
    refs/pages were visited. Besides bare :class:`DeviceRef` leaves this
    also recognizes objects exposing ``release_pages()``."""
    n = 0
    is_leaf = lambda l: isinstance(l, DeviceRef) or hasattr(l, "release_pages")
    for leaf in pytree.tree_leaves(tree, is_leaf=is_leaf):
        if isinstance(leaf, DeviceRef):
            leaf.release()
            n += 1
        elif hasattr(leaf, "release_pages"):
            n += leaf.release_pages()
    return n


def _host_tensor(value, dtype=None) -> torch.Tensor:
    """A CPU tensor holding a host value: numpy arrays (bfloat16 ones
    included), objects with ``__array__``, scalars and lists."""
    if dtype is not None and not hasattr(value, "dtype"):
        # untyped Python scalars/lists adopt the requested dtype
        return torch.tensor(value, dtype=to_torch_dtype(dtype))
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 extension type: widen exactly, narrow back
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr)


def as_device_array(value, device=None, dtype=None) -> torch.Tensor:
    """Normalize message payloads (host arrays, scalars, tensors or
    DeviceRefs) to a device tensor, transferring host data if needed
    (paper: the first actor in a chain transfers input data to the
    device). ``device`` defaults to the current CUDA device; a host value
    bound for the CPU is copied, never aliased."""
    device = getattr(device, "torch_device", device)
    arr = value.array if isinstance(value, DeviceRef) else value
    if isinstance(arr, torch.Tensor):
        if device is not None and arr.device != torch.device(device):
            arr = arr.to(device)
        return arr
    host = _host_tensor(arr, dtype)
    target = torch.device(device) if device is not None else default_device()
    if target.type == "cpu":
        # from_numpy shares the caller's buffer; a kernel may update its
        # inputs in place, so the CPU gets a copy as the card would
        return host.clone() if isinstance(arr, np.ndarray) else host
    return host.to(target)
