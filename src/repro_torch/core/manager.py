"""Device discovery and program bookkeeping (paper Fig. 2: manager /
platform / device / program).

* ``Platform`` groups the devices of one ``torch.device`` type (``cuda``,
  ``cpu``) — the analogue of an OpenCL platform.
* ``Device`` wraps a ``torch.device``, owns the one CUDA stream on which
  every kernel actor bound to it launches (the per-device command queue),
  and tracks an outstanding-dispatch counter.
* ``Program`` maps kernel names to callables, with a per-key cache of
  whatever a kernel actor builds from them.
* ``DeviceManager`` is the ``actor_system`` module that "performs platform
  discovery lazily on first access and offers an interface to spawn OpenCL
  actors" (paper §3.2).

Binding rule: an entry point runs on the card unless the caller asks for
the CPU. :meth:`DeviceManager.find_device` with no platform returns the
first CUDA device (or the device the ``ActorSystem`` was created with) and
raises :class:`LookupError` when there is none; the CPU is bound only
through ``ActorSystem(device="cpu")``, ``find_device(platform="cpu")`` or
an explicit ``device=`` on ``spawn``.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..analysis.runtime import make_lock
from .signature import NDRange

__all__ = ["Platform", "Device", "Program", "DeviceManager"]


def _indexed(device) -> torch.device:
    """``torch.device(device)``, with a bare ``cuda`` read as ``cuda:0``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Device:
    """A device with its launch stream, a dispatch (command-queue) counter
    and live-memory watermarks (fed by the DeviceRef registry)."""

    def __init__(self, torch_device: torch.device, platform: "Platform"):
        self.torch_device = torch_device
        self.platform = platform
        self._inflight = 0
        self._stream = None
        self._lock = make_lock("Device")

    @property
    def name(self) -> str:
        return f"{self.torch_device.type}:{self.torch_device.index or 0}"

    @property
    def device_kind(self) -> str:
        if self.torch_device.type == "cuda":
            return torch.cuda.get_device_name(self.torch_device)
        return self.torch_device.type

    @property
    def stream(self) -> Optional["torch.cuda.Stream"]:
        """The stream every kernel actor on this device launches on
        (created on first use); ``None`` for the CPU."""
        if self.torch_device.type != "cuda":
            return None
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self.torch_device)
            return self._stream

    def launch_context(self):
        """Context in which a kernel actor unwraps, launches and wraps:
        this device current and its stream the current stream. Pool
        threads each have their own current stream, so every dispatch
        enters it anew."""
        stream = self.stream
        if stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.torch_device))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def queue_depth(self) -> int:
        return self._inflight

    # -- memory watermarks (DeviceRef registry) -------------------------------
    def live_bytes(self) -> int:
        """Bytes currently held by live DeviceRefs on this device."""
        from .memref import registry
        return registry.live_bytes(self.torch_device)

    def peak_bytes(self) -> int:
        """High watermark of DeviceRef bytes ever resident on this device."""
        from .memref import registry
        return registry.peak_bytes(self.torch_device)

    def page_stats(self) -> dict:
        """KV page-pool pressure on this device
        (:class:`~repro_torch.serve.kvpool.PagePool`\\ s placed here)."""
        from .memref import registry
        return registry.page_stats(self.torch_device)

    def _dispatch_started(self):
        with self._lock:
            self._inflight += 1

    def _dispatch_finished(self):
        with self._lock:
            self._inflight -= 1

    def __repr__(self):
        return (f"Device({self.name}, inflight={self._inflight}, "
                f"live_bytes={self.live_bytes()})")


class Platform:
    def __init__(self, backend: str, devices: Sequence[torch.device]):
        self.name = backend
        self.devices = [Device(d, self) for d in devices]

    def __repr__(self):
        return f"Platform({self.name}, {len(self.devices)} devices)"


class Program:
    """Named kernels + per-key build cache.

    ``kernels`` maps a kernel name to a callable. ``retrieve`` mirrors
    ``clCreateKernel``-by-name; ``compiled`` caches what a kernel actor
    builds from a kernel the way OpenCL caches ``cl_program`` binaries per
    device.
    """

    def __init__(self, kernels: Dict[str, Callable], device: Optional[Device] = None,
                 options: Optional[Dict[str, Any]] = None):
        self.kernels = dict(kernels)
        self.device = device
        self.options = dict(options or {})
        self._cache: Dict[Any, Any] = {}
        self._lock = make_lock("Program")

    def retrieve(self, name: str) -> Callable:
        try:
            return self.kernels[name]
        except KeyError:
            raise KeyError(f"program has no kernel named {name!r}; "
                           f"available: {sorted(self.kernels)}") from None

    def compiled(self, key: Any, build: Callable[[], Any]) -> Any:
        with self._lock:
            if key not in self._cache:
                self._cache[key] = build()
            return self._cache[key]


class DeviceManager:
    """Lazily discovers platforms and spawns kernel actors (paper §3.2)."""

    def __init__(self, system):
        self.system = system
        self._platforms: Optional[list[Platform]] = None
        self._lock = make_lock("DeviceManager")

    # -- discovery ------------------------------------------------------
    @property
    def platforms(self) -> list[Platform]:
        with self._lock:
            if self._platforms is None:
                self._platforms = self._discover()
            return self._platforms

    def _discover(self) -> list[Platform]:
        plats = []
        if torch.cuda.is_available():
            plats.append(Platform("cuda", [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]))
        plats.append(Platform("cpu", [torch.device("cpu")]))
        return plats

    def _system_device(self) -> Optional[torch.device]:
        dev = getattr(self.system, "device", None)
        return None if dev is None else _indexed(dev)

    def devices(self) -> list[Device]:
        """The devices placement may choose from: the system's device when
        it was created with one, else every CUDA device (empty without a
        card — the CPU is never chosen unasked)."""
        want = self._system_device()
        every = [d for p in self.platforms for d in p.devices]
        if want is not None:
            return [d for d in every if d.torch_device == want]
        return [d for d in every if d.torch_device.type == "cuda"]

    def find_device(self, *, platform: Optional[str] = None, index: int = 0) -> Device:
        """Default binding is the system's device, else the first CUDA
        device (paper §3.6); :class:`LookupError` when there is none."""
        if platform is None:
            devs = self.devices()
            if not devs:
                raise LookupError(
                    "no CUDA device is available; create the system with "
                    "ActorSystem(device='cpu') or pass device= to run on "
                    "the CPU")
        else:
            devs = [d for p in self.platforms if p.name == platform
                    for d in p.devices]
        if not devs:
            raise LookupError(f"no device for platform={platform!r}")
        return devs[index]

    def resolve(self, device) -> Device:
        """The :class:`Device` for a ``Device``, a ``torch.device`` or a
        device string."""
        if isinstance(device, Device):
            return device
        want = _indexed(device)
        for d in (d for p in self.platforms for d in p.devices):
            if d.torch_device == want:
                return d
        raise LookupError(f"no device {want}")

    def memory_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-device memory watermarks: live DeviceRef bytes, the peak
        (high watermark), current dispatch queue depth — the signals the
        pool's least-loaded policy ranks by — plus page-pool pressure."""
        out: Dict[str, Dict[str, Any]] = {}
        for d in self.devices():
            ps = d.page_stats()
            out[d.name] = {"live_bytes": d.live_bytes(),
                           "peak_bytes": d.peak_bytes(),
                           "queue_depth": d.queue_depth(),
                           "pages_total": ps["pages_total"],
                           "pages_free": ps["pages_free"],
                           "pages_shared": ps["pages_shared"],
                           "fragmentation": ps["fragmentation"]}
        return out

    def pick_device(self, *, context: str = "manager") -> Device:
        """Cost-ranked device choice through the process-wide
        :class:`~repro_torch.core.placement.PlacementService` (least live
        DeviceRef bytes, then queue depth, deterministic name tie-break)."""
        from .placement import service as placement_service
        return placement_service().pick_device(self.devices(),
                                               context=context).chosen

    def _spawn_device(self, device) -> Device:
        return self.resolve(device) if device is not None else self.find_device()

    # -- program / actor creation -------------------------------------------
    def create_program(self, kernels: Dict[str, Callable],
                       device: Optional[Device] = None, **options) -> Program:
        return Program(kernels, self._spawn_device(device), options)

    def spawn(self, source, name: Optional[str] = None,
              nd_range: Optional[NDRange] = None, *specs, **kwargs):
        """Spawn an OpenCL actor (paper Listing 2/3/5).

        v2 form: ``source`` is a :func:`repro_torch.core.kernel`-decorated
        callable (a :class:`~repro_torch.core.api.KernelDecl`) that already
        carries its signature and ND-range; ``name``/``nd_range`` and a
        ``device=`` keyword act as per-spawn overrides.

        v1 form (deprecated shim): ``source`` is a callable or a
        :class:`Program` plus positional ``name``, ``nd_range``, and
        ``*specs``. Optional ``preprocess``/``postprocess`` keyword
        arguments mirror the paper's conversion functions in both forms.
        """
        from .api import KernelDecl     # local import: avoid cycle
        from .facade import KernelActor
        if isinstance(source, KernelDecl):
            decl = source
            overrides = {}
            if name is not None:
                overrides["name"] = name
            if nd_range is not None:
                overrides["nd_range"] = nd_range
            if specs:
                overrides["specs"] = specs
            for opt in ("preprocess", "postprocess", "donate"):
                if opt in kwargs:
                    overrides[opt] = kwargs.pop(opt)
            if overrides:
                decl = decl.with_options(**overrides)
            device = self._spawn_device(kwargs.pop("device", None))
            lazy_init = kwargs.pop("lazy_init", True)
            emit = kwargs.pop("emit", "declared")
            if kwargs:
                raise TypeError(f"unknown spawn options: {sorted(kwargs)}")
            actor = KernelActor(fn=decl.fn, name=decl.name,
                                nd_range=decl.nd_range, specs=decl.specs,
                                device=device, program=None,
                                preprocess=decl.preprocess,
                                postprocess=decl.postprocess,
                                donate=decl.donate, emit=emit)
            return self.system.spawn(actor, lazy_init=lazy_init)
        warnings.warn(
            "positional DeviceManager.spawn(source, name, nd_range, *specs) "
            "is deprecated; declare kernels with @repro_torch.core.kernel",
            PendingDeprecationWarning, stacklevel=2)
        if isinstance(source, Program):
            program, fn = source, source.retrieve(name)
            device = kwargs.pop("device", None) or program.device
        else:
            if not callable(source):
                raise TypeError("source must be a callable or Program")
            program, fn = None, source
            device = kwargs.pop("device", None)
        actor = KernelActor(fn=fn, name=name or getattr(fn, "__name__", "kernel"),
                            nd_range=nd_range, specs=specs,
                            device=self._spawn_device(device),
                            program=program, **kwargs)
        return self.system.spawn(actor)

    def spawn_pool(self, source, n: int, *, policy: str = "round_robin",
                   devices: Optional[Sequence[Device]] = None,
                   default_timeout: Optional[float] = 120.0, **kwargs):
        """Spawn ``n`` replicas of a kernel behind one pool ref.

        Replicas are placed round-robin over ``devices`` (default: every
        device placement may choose, see :meth:`devices`); the returned
        :class:`~repro_torch.core.api.ActorPool` routes per ``policy``
        ("round_robin" | "least_loaded", the latter keyed on outstanding
        requests then ``Device.queue_depth()``). ``default_timeout``
        becomes the pool's ``ask`` timeout (None = wait forever).
        """
        from .api import ActorPool
        if n < 1:
            raise ValueError("pool size must be >= 1")
        devs = [self.resolve(d) for d in devices] if devices else self.devices()
        if not devs:
            raise LookupError("no device to place the pool on")
        refs, placed = [], []
        for i in range(n):
            dev = devs[i % len(devs)]
            refs.append(self.spawn(source, device=dev, **kwargs))
            placed.append(dev)
        return ActorPool(self.system, refs, policy=policy, devices=placed,
                         default_timeout=default_timeout)
