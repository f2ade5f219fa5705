"""Spill-based wire format for cross-node actor messages (paper §3.5) —
the port of the JAX package's ``repro/net/wire.py``.

The paper offers two serialization policies for ``mem_ref``: (a) prohibit
it, (b) serialize through an explicit host copy. ``repro_torch.core.memref``
implements both for the single process; this module is where option (b)
meets an actual wire. Every frame is a pickled Python object with its
:class:`~repro_torch.core.memref.DeviceRef` leaves normalized at the
boundary:

* **outgoing** — a live ref is spilled exactly once. Request/``send``
  payloads use :meth:`DeviceRef.spill_copy` (the sender keeps its
  device-resident ref, so an exactly-once chunk re-issue after the remote
  node dies can replay the same payload locally); reply values use
  in-place :meth:`DeviceRef.spill` (ownership transfers to the remote
  caller, so the sender's device buffer is dropped at the boundary).
  Already-spilled refs travel as-is — their spill was the caller's
  explicit stage boundary.
* **incoming** — every spilled ref is unspilled exactly once onto the
  *receiver-chosen* device, so the payload lands device-resident and the
  handling actor never sees a wire artifact. The copy is enqueued on the
  receiving thread's current stream and the ref records that stream, so
  a reader on any other stream (a kernel actor's device stream) waits for
  it (:meth:`DeviceRef.array`).
* **compression (optional)** — float refs are re-expressed in the int8
  wire format of :func:`repro_torch.dist.collectives.quantize_ref` before
  spilling: the wire carries the int8 payload plus one float scale (~4x
  fewer bytes), and the receiver dequantizes back to the original dtype
  on its device. Lossy (relative error ≤ 1/254) and therefore opt-in per
  node.

Raw ``torch.Tensor`` payload leaves travel by value as CPU tensors of
the same dtype (bfloat16 included, which numpy lacks) and arrive as CPU
tensors. A CUDA tensor is never pickled as such: unpickling one restores
it on the sender's ``cuda:<index>``, which would hide the receiver's
device choice. Refs nested inside arbitrary user objects are *not*
discovered — they hit ``DeviceRef.__reduce__``'s refusal with its
explicit-spill message, which is the intended failure mode for
undeclared device state crossing the wire.
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Any, Optional

import torch

from ..core.memref import DeviceRef

__all__ = ["encode", "decode", "encoded_size", "WireRef"]

#: frame header: 4-byte big-endian payload length
HEADER = struct.Struct(">I")

#: frames larger than this are refused (corrupt-stream guard)
MAX_FRAME_BYTES = 1 << 31


class WireRef:
    """An int8-compressed ref in flight: spilled int8 payload + absmax
    scale + the original dtype **and access rights** to restore on
    arrival (compression must not widen a restricted view back to
    ``rw``). Pickles through the inner spilled ref's ``__reduce__``."""

    __slots__ = ("ref", "scale", "dtype", "access")

    def __init__(self, ref: DeviceRef, scale: float, dtype: torch.dtype,
                 access: str = "rw"):
        self.ref = ref
        self.scale = scale
        self.dtype = dtype
        self.access = access

    def __repr__(self):
        return (f"WireRef(int8->{self.dtype}, scale={self.scale:.3g}, "
                f"{self.access}, {self.ref!r})")


def _freeze(obj: Any, compress: bool, consume: bool) -> Any:
    if isinstance(obj, DeviceRef):
        if obj.is_spilled:
            return obj
        if compress and obj.dtype.is_floating_point:
            from ..dist.collectives import quantize_ref
            q, scale = quantize_ref(obj.array)
            q.spill()
            access = obj.access
            if consume:
                obj.release()
            return WireRef(q, scale, obj.dtype, access)
        if consume:
            return obj.spill()
        return obj.spill_copy()
    if isinstance(obj, tuple):
        vals = [_freeze(v, compress, consume) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, list):
        return [_freeze(v, compress, consume) for v in obj]
    if isinstance(obj, dict):
        return {k: _freeze(v, compress, consume) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        # a copy of exactly this tensor's elements: pickling a view
        # would ship its whole storage
        return obj.detach().to("cpu", copy=True)
    return obj


def _thaw(obj: Any, device) -> Any:
    if isinstance(obj, WireRef):
        from ..dist.collectives import dequantize_ref
        obj.ref.unspill(device)
        out = dequantize_ref(obj.ref.array, obj.scale, dtype=obj.dtype,
                             access=obj.access)
        obj.ref.release()
        return out
    if isinstance(obj, DeviceRef):
        return obj.unspill(device)
    if isinstance(obj, tuple):
        vals = [_thaw(v, device) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    if isinstance(obj, list):
        return [_thaw(v, device) for v in obj]
    if isinstance(obj, dict):
        return {k: _thaw(v, device) for k, v in obj.items()}
    return obj


def encode(obj: Any, *, compress: Any = False, consume: bool = False,
           peer: Optional[str] = None) -> bytes:
    """Serialize ``obj`` for the wire (see module doc for the ref policy).

    ``consume=True`` spills live refs in place (reply direction:
    ownership transfers); the default clones (request direction: sender
    retains residency for replay).

    ``compress`` may be a bool (the node's static setting) or ``"auto"``,
    in which case the spill-boundary choice is delegated per payload to
    the process-wide placement service's wire-cost model: int8 is used
    only when the payload is large enough that quantization amortizes the
    bytes it saves on this (optionally ``peer``-specific) hop.
    """
    if compress == "auto":
        from ..core.memref import payload_nbytes
        from ..core.placement import service as placement_service
        compress = placement_service().choose_compress(
            payload_nbytes(obj), peer)
    return pickle.dumps(_freeze(obj, bool(compress), consume),
                        protocol=pickle.HIGHEST_PROTOCOL)


def decode(data: bytes, *, device=None) -> Any:
    """Inverse of :func:`encode`: unpickle and land every ref on
    ``device`` (a ``torch.device``, a device string or the runtime's
    ``Device`` wrapper). ``None`` lands each ref on the current CUDA
    device (:class:`LookupError` without one); a node passes its own
    system's device."""
    return _thaw(pickle.loads(data), device)


def encoded_size(obj: Any, *, compress: bool = False) -> int:
    """Wire bytes ``obj`` would occupy — measured **without** mutating
    any live ref (raw vs int8-compressed spills)."""
    return len(encode(obj, compress=compress, consume=False))


# ----------------------------------------------------------------------------
# control-frame envelope
# ----------------------------------------------------------------------------
# The node transport separates the *envelope* (frame tag, request ids,
# actor ids — primitives only, plus user payloads as already-encoded
# ``bytes`` blobs) from the payloads themselves. The envelope always
# unpickles; a payload blob that does not (e.g. a spawn_remote behavior
# defined in the driver's ``__main__``, unimportable on the worker) fails
# only its own request with a clean error reply instead of tearing the
# connection down.
def encode_frame(frame: tuple) -> bytes:
    return pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)


def decode_frame(data: bytes) -> tuple:
    return pickle.loads(data)


# ----------------------------------------------------------------------------
# frame I/O over a socket-like object
# ----------------------------------------------------------------------------
def write_frame(sock, data: bytes) -> None:
    sock.sendall(HEADER.pack(len(data)) + data)


def read_frame(sock, on_chunk: Optional[Any] = None) -> Optional[bytes]:
    """One length-prefixed frame, or ``None`` on clean EOF.

    ``on_chunk()`` (if given) is called after every successful ``recv`` —
    the node's liveness tracker counts arriving *bytes*, not complete
    frames, so a large frame mid-transfer never reads as a dead peer.
    """
    head = _read_exact(sock, HEADER.size, on_chunk)
    if head is None:
        return None
    (length,) = HEADER.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"oversized frame ({length} bytes)")
    body = _read_exact(sock, length, on_chunk)
    if body is None:
        raise ConnectionError("EOF mid-frame")
    return body


def _read_exact(sock, n: int, on_chunk=None) -> Optional[bytes]:
    buf = io.BytesIO()
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            return None
        if on_chunk is not None:
            on_chunk()
        buf.write(chunk)
        remaining -= len(chunk)
    return buf.getvalue()
