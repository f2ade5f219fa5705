"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``;
pointers and the stream travel as ``c_void_p``. A library is built at
first use into ``kernels/build/`` (listed in ``.gitignore``) under a name
that hashes its source, every shared header ``csrc/*.cuh`` and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.

Nothing here runs at import time: the CPU tests import every module, and
a machine without ``nvcc`` only fails when a kernel is launched.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Counter, Dict, Iterable, Optional, Sequence, Tuple

from .. import trace

__all__ = ["CudaKernel", "build_all", "device_sm_count", "BUILD_DIR",
           "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        return os.path.join(CUDA_HOME, "bin", name)
    raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to "
                       "build the repro_torch kernels")


def _nvcc() -> str:
    return _cuda_tool("nvcc")


@functools.lru_cache(maxsize=None)
def device_sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (kernels size
    their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


_SASS_FUNCTION = re.compile(r"Function : (\S+)")
#: an instruction line: /*offset*/ [@predicate] OPCODE[.modifiers] ...
_SASS_OPCODE = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


class CudaKernel:
    """One hand-written kernel: where its source is, which TPU kernel it
    replaces, its exported C functions, and how often it was launched.

    ``launches`` is a plain integer that :meth:`launch` raises by one for
    every kernel launch, and ``function_launches`` counts the same launches
    by exported function (a library may export several); a run resets both
    (:meth:`reset_launches`) and reads them afterwards to show that its
    path went through the kernel. ``trace.counters()`` reads them too, as
    ``cuda.launches`` (summed over the kernels) and ``cuda.<function>``.
    """

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence], replaces: str):
        self.name = name
        self.source = source
        self.functions = dict(functions)
        self.replaces = replaces
        self.launches = 0
        self.function_launches: Counter = collections.Counter()
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        trace.reads(self, CudaKernel._counts)

    def _counts(self) -> Dict[str, int]:
        with self._lock:
            return {"cuda.launches": self.launches,
                    **{f"cuda.{fn}": n
                       for fn, n in self.function_launches.items()}}

    # -- building ----------------------------------------------------------
    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for part in (self.source_path, *sorted(CSRC_DIR.glob("*.cuh"))):
            digest.update(part.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{digest.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
        """Start ``nvcc`` unless the library is already built; returns the
        process, the temporary output and the final library path."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _finish_build(self, build: Tuple[subprocess.Popen, Path, Path]) -> None:
        """Wait for ``nvcc``; move the library into place or raise with
        the compiler's output."""
        proc, tmp, out = build
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kernel {self.name!r} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                build = self._start_build()
                if build is not None:
                    self._finish_build(build)
                lib = ctypes.CDLL(str(self.library_path()))
                for fn_name, argtypes in self.functions.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.repro_error_string.argtypes = [ctypes.c_int]
                lib.repro_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    # -- launching ---------------------------------------------------------
    def _call(self, fn_name: str, *args) -> None:
        lib = self._load()
        err = getattr(lib, fn_name)(*args)
        if err != 0:
            msg = lib.repro_error_string(err).decode()
            raise RuntimeError(f"kernel {self.name!r} ({fn_name}) failed: "
                               f"CUDA error {err}: {msg}")

    def launch(self, fn_name: str, *args) -> None:
        """Call one exported launch function; raise if CUDA refused it."""
        self._call(fn_name, *args)
        with self._lock:
            self.launches += 1
            self.function_launches[fn_name] += 1

    def reset_launches(self) -> None:
        """Set ``launches`` and every ``function_launches`` count to 0."""
        with self._lock:
            self.launches = 0
            self.function_launches.clear()

    def query(self, fn_name: str, *args) -> None:
        """Call an exported function that launches nothing (an attribute
        query); raise on a CUDA error. The launch count does not move."""
        self._call(fn_name, *args)

    def sass_opcodes(self) -> Dict[str, Counter]:
        """Opcodes of each kernel in the built library, as ``cuobjdump
        -sass`` disassembles it: mangled kernel name -> opcode -> count
        (modifiers dropped: ``HGMMA.64x128x16.F32.BF16`` counts as
        ``HGMMA``). Builds the library; launches nothing."""
        self._load()
        sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                               str(self.library_path())],
                              capture_output=True, text=True, check=True).stdout
        out: Dict[str, Counter] = {}
        fn = None
        for line in sass.splitlines():
            head = _SASS_FUNCTION.search(line)
            if head:
                fn = head.group(1)
                out[fn] = collections.Counter()
                continue
            op = _SASS_OPCODE.search(line)
            if op and fn is not None:
                out[fn][op.group(1)] += 1
        return out


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library with one ``nvcc`` per source, all
    started together; returns the wall seconds it took. Raises on the
    first failed build after every started build has ended."""
    t0 = time.perf_counter()
    started = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, build in started:
        if build is None:
            continue
        try:
            k._finish_build(build)
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    for k, _ in started:
        k._load()
    return time.perf_counter() - t0
