"""Kernel argument signatures and index spaces (paper §3.4).

The paper's OpenCL actors are spawned with a list of ``in``, ``out``,
``in_out``, ``local`` and ``priv`` declarations mirroring the kernel
signature, plus an ``nd_range`` describing the work-item index space.
This module is the PyTorch adaptation:

* ``NDRange``      — global dims / offsets / local dims: the logical index
                     space of the kernel and its block shape.
* ``In/Out/InOut`` — typed argument declarations over torch dtypes.
                     ``InOut`` arguments are updated in place and the
                     incoming ref is **donated** — the analogue of a
                     read-write ``cl_mem``.
* ``Local``        — scratch request (OpenCL ``__local``).
* ``Priv``         — accepted for API fidelity, ignored: private memory is
                     register-allocated by the compiler.

Every declaration may ask for value semantics (host round-trip) or
reference semantics (``mem_ref<T>`` → :class:`repro_torch.core.memref.DeviceRef`)
via ``as_ref`` — the paper's ``in_out<uint, ref, ref>`` pattern.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import SignatureMismatch

__all__ = [
    "NDRange",
    "dim_vec",
    "In",
    "Out",
    "InOut",
    "Local",
    "Priv",
    "KernelSignature",
    "to_torch_dtype",
    "to_numpy_dtype",
    "dtype_name",
]

#: torch dtypes with a numpy counterpart (bfloat16 has none in numpy)
_TORCH_TO_NUMPY = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8, torch.int8: np.int8,
    torch.uint16: np.uint16, torch.int16: np.int16,
    torch.uint32: np.uint32, torch.int32: np.int32,
    torch.uint64: np.uint64, torch.int64: np.int64,
    torch.float16: np.float16, torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
}
_NUMPY_TO_TORCH = {np.dtype(v): k for k, v in _TORCH_TO_NUMPY.items()}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype for a torch dtype, a numpy dtype (or scalar type), or
    a dtype name; numpy's ``bfloat16`` extension type maps by name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and hasattr(torch, dtype) and \
            isinstance(getattr(torch, dtype), torch.dtype):
        return getattr(torch, dtype)
    npd = np.dtype(dtype)
    if npd.name == "bfloat16":
        return torch.bfloat16
    try:
        return _NUMPY_TO_TORCH[npd]
    except KeyError:
        raise TypeError(f"no torch dtype for {dtype!r}") from None


def to_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (TypeError for bfloat16, which
    numpy lacks)."""
    td = to_torch_dtype(dtype)
    try:
        return np.dtype(_TORCH_TO_NUMPY[td])
    except KeyError:
        raise TypeError(f"{td} has no numpy dtype") from None


def dtype_name(dtype) -> str:
    """Short name of a dtype, e.g. ``uint32``."""
    return str(to_torch_dtype(dtype)).replace("torch.", "")


def dim_vec(*dims: int) -> Tuple[int, ...]:
    """One- to three-dimensional index-space size (paper Listing 2)."""
    if not 1 <= len(dims) <= 3:
        raise ValueError("dim_vec takes 1..3 dimensions, got %d" % len(dims))
    return tuple(int(d) for d in dims)


@dataclasses.dataclass(frozen=True)
class NDRange:
    """N-dimensional index space (paper §2.3 "NDRange").

    ``global_dims`` identify one logical work item per tuple; ``offsets``
    shift global IDs; ``local_dims`` map to the kernel's block shape.
    """

    global_dims: Tuple[int, ...]
    offsets: Tuple[int, ...] = ()
    local_dims: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "global_dims", tuple(int(d) for d in self.global_dims))
        object.__setattr__(self, "offsets", tuple(int(d) for d in self.offsets))
        object.__setattr__(self, "local_dims", tuple(int(d) for d in self.local_dims))
        if not 1 <= len(self.global_dims) <= 3:
            raise ValueError("NDRange supports 1..3 dimensions")
        if self.offsets and len(self.offsets) != len(self.global_dims):
            raise ValueError("offsets rank must match global rank")
        if self.local_dims:
            if len(self.local_dims) != len(self.global_dims):
                raise ValueError("local rank must match global rank")
            for g, l in zip(self.global_dims, self.local_dims):
                if g % l != 0:
                    raise ValueError(
                        f"global dim {g} not divisible by local dim {l}"
                    )

    @property
    def total_items(self) -> int:
        return math.prod(self.global_dims)

    def grid(self) -> Tuple[int, ...]:
        """Number of blocks per dimension."""
        if not self.local_dims:
            return self.global_dims
        return tuple(g // l for g, l in zip(self.global_dims, self.local_dims))

    def split(self, fractions: Sequence[float]) -> Tuple["NDRange", ...]:
        """Split the leading dimension proportionally (paper §5.4 offload).

        Returns one sub-range per non-empty fraction, with offsets adjusted
        so global IDs remain consistent across devices.
        """
        total = self.global_dims[0]
        sizes = _proportional_split(total, fractions)
        out = []
        start = self.offsets[0] if self.offsets else 0
        rest_dims = self.global_dims[1:]
        rest_offs = self.offsets[1:] if self.offsets else (0,) * len(rest_dims)
        for sz in sizes:
            if sz == 0:
                out.append(None)
                continue
            out.append(
                NDRange(
                    (sz,) + rest_dims,
                    offsets=(start,) + tuple(rest_offs),
                    local_dims=self.local_dims,
                )
            )
            start += sz
        return tuple(out)


def _proportional_split(total: int, fractions: Sequence[float]) -> Tuple[int, ...]:
    if abs(sum(fractions) - 1.0) > 1e-6:
        raise ValueError("fractions must sum to 1")
    sizes = [int(math.floor(total * f)) for f in fractions]
    # distribute the remainder to the largest fractions first
    rem = total - sum(sizes)
    order = sorted(range(len(fractions)), key=lambda i: -fractions[i])
    for i in range(rem):
        sizes[order[i % len(order)]] += 1
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class _ArgSpec:
    dtype: Any = torch.float32
    shape: Optional[Tuple[int, ...]] = None
    #: value (host array) or reference (DeviceRef) semantics, per direction
    as_ref: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.dtype)

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy counterpart (TypeError for bfloat16)."""
        return to_numpy_dtype(self.dtype)

    def matches(self, value_dtype) -> bool:
        """Does a value's dtype (torch or numpy) equal the declared one?"""
        try:
            return to_torch_dtype(value_dtype) == self.torch_dtype
        except TypeError:
            return False


@dataclasses.dataclass(frozen=True)
class In(_ArgSpec):
    """Read-only kernel input, extracted from the incoming message."""

    direction = "in"


@dataclasses.dataclass(frozen=True)
class Out(_ArgSpec):
    """Kernel output, allocated by the framework.

    The paper defaults the size to the number of work items; a
    ``size_fn(inputs, nd_range) -> shape`` overrides it (paper §3.4), or a
    static ``shape``/``size`` may be given (paper Listing 5 ``out<uint,
    ref>{2*k}``).
    """

    direction = "out"
    size: Optional[int] = None
    size_fn: Optional[Callable[..., Tuple[int, ...]]] = None

    def resolved_shape(self, inputs, nd_range: NDRange) -> Tuple[int, ...]:
        if self.shape is not None:
            return tuple(self.shape)
        if self.size is not None:
            return (int(self.size),)
        if self.size_fn is not None:
            shp = self.size_fn(inputs, nd_range)
            if isinstance(shp, int):
                return (shp,)
            return tuple(int(s) for s in shp)
        return (nd_range.total_items,)


@dataclasses.dataclass(frozen=True)
class InOut(_ArgSpec):
    """Read-write argument: consumed from the message, updated in place,
    returned in the response; an incoming ref is **donated**."""

    direction = "in_out"


@dataclasses.dataclass(frozen=True)
class Local(_ArgSpec):
    """Per-block scratch (OpenCL ``__local``); never crosses messages."""

    direction = "local"
    size: Optional[int] = None

    def resolved_shape(self) -> Tuple[int, ...]:
        if self.shape is not None:
            return tuple(self.shape)
        if self.size is not None:
            return (int(self.size),)
        raise ValueError("Local requires shape or size")


@dataclasses.dataclass(frozen=True)
class Priv(_ArgSpec):
    """Accepted for OpenCL API fidelity; registers are compiler-managed."""

    direction = "priv"


class KernelSignature:
    """Orders and validates kernel arguments (paper §3.4).

    The wrapped callable receives all ``In``/``InOut`` tensors in signature
    order and must return all ``Out``/``InOut`` tensors in signature order
    — the functional bridge for OpenCL's by-reference outputs.
    """

    def __init__(self, *specs: _ArgSpec):
        self.specs = tuple(specs)
        self.input_specs = tuple(s for s in specs if s.direction in ("in", "in_out"))
        self.output_specs = tuple(s for s in specs if s.direction in ("out", "in_out"))
        self.local_specs = tuple(s for s in specs if s.direction == "local")
        #: indices (into the callable's positional args) eligible for donation
        self.donate_argnums = tuple(
            i for i, s in enumerate(self.input_specs) if s.direction == "in_out"
        )

    def match_inputs(self, payload: Sequence[Any]):
        """Pattern-match a message payload against the input specs.

        Mirrors the paper's auto-generated pattern: a message is matched
        against all ``in`` and ``in_out`` kernel arguments.
        """
        if len(payload) != len(self.input_specs):
            raise SignatureMismatch(
                f"expected {len(self.input_specs)} inputs, got {len(payload)}"
            )
        return tuple(payload)

    def __repr__(self):
        return f"KernelSignature({', '.join(type(s).__name__ for s in self.specs)})"
