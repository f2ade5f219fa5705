"""Static and dynamic analysis for the port's actor runtime.

* ``repro_torch.analysis.lint`` + ``repro_torch.analysis.rules`` — the
  AST linter, a copy of the JAX package's
  (``python -m repro_torch.analysis [paths] [--baseline FILE]``; with no
  paths it lints ``src/repro_torch``, which is clean without a baseline:
  its one accepted site carries a ``# lint:`` tag). The lock-order rule
  reads this package's ``order.py``.

* ``repro_torch.analysis.runtime`` — ``TrackedLock``/``TrackedRLock`` and
  the ``make_lock``/``make_rlock`` seam (activated by ``REPRO_ANALYSIS=1``),
  plus the DeviceRef leak-sentinel helper.
* ``repro_torch.analysis.order`` / ``ORDER.md`` — the canonical
  cross-module lock hierarchy, with the same lock names and ranks as the
  JAX package, so one ``REPRO_ANALYSIS=1`` run covers both.
"""
from .order import CANONICAL_LOCK_ORDER, LOCK_RANKS, order_path, rank_of
from .runtime import (LockOrderViolation, TrackedLock, TrackedRLock,
                      analysis_enabled, lock_order_cycles,
                      lock_order_graph, make_lock, make_rlock,
                      recorded_violations, reset_lock_graph)

__all__ = [
    "CANONICAL_LOCK_ORDER", "LOCK_RANKS", "order_path", "rank_of",
    "LockOrderViolation", "TrackedLock", "TrackedRLock",
    "analysis_enabled", "lock_order_cycles", "lock_order_graph",
    "make_lock", "make_rlock", "recorded_violations", "reset_lock_graph",
]
