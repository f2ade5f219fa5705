"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

Layout: ``csrc/<name>.cu`` holds a kernel, ``<module>.py`` its thin
wrapper (a ``torch.library.custom_op`` with a fake implementation, but
for ``adamw.py``, whose calls take whole trees of leaves, plus the
:class:`~repro_torch.kernels.build.CudaKernel` that builds, launches and
counts it), ``ops.py`` the public operators and ``ref.py`` the plain
PyTorch versions. :data:`KERNELS` lists the kernels of this package.
"""
from . import adamw, ops, ref
from .adamw import KERNEL as ADAMW
from .build import CudaKernel, build_all
from .flash_attention import KERNEL as FLASH_ATTENTION
from .mandelbrot import KERNEL as MANDELBROT
from .matmul import KERNEL as MATMUL
from .ops import (compact_gather, flash_attention, mandelbrot, matmul,
                  radix_sort, stream_compact, wah_interleave)
from .radix_sort import KERNEL as RADIX_PASS
from .stream_compact import KERNEL as LOCAL_COMPACT
from .wah import KERNEL as WAH_INTERLEAVE

#: every hand-written kernel, in the order the main path first reaches them
KERNELS = (MATMUL, RADIX_PASS, WAH_INTERLEAVE, LOCAL_COMPACT, MANDELBROT,
           ADAMW, FLASH_ATTENTION)

__all__ = ["adamw", "ops", "ref", "CudaKernel", "build_all", "KERNELS",
           "ADAMW", "MATMUL", "MANDELBROT", "RADIX_PASS", "LOCAL_COMPACT",
           "WAH_INTERLEAVE", "FLASH_ATTENTION",
           "compact_gather", "flash_attention", "mandelbrot", "matmul",
           "radix_sort", "stream_compact", "wah_interleave"]
