"""The canonical cross-module lock order, parsed from ``ORDER.md``.

``ORDER.md`` (next to this module) is the single source of truth; this
module turns its numbered list into :data:`CANONICAL_LOCK_ORDER` so the
static ``lock-order`` lint rule and the dynamic
:class:`~repro_torch.analysis.runtime.TrackedLock` consume one artifact —
editing the doc edits the checked policy, and drift between the two is
structurally impossible.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

__all__ = ["CANONICAL_LOCK_ORDER", "LOCK_RANKS", "rank_of", "order_path"]

_ITEM_RE = re.compile(r"^\s*\d+\.\s+`([A-Za-z_][A-Za-z0-9_.]*)`")


def order_path() -> str:
    """Absolute path of the ORDER.md this process is enforcing."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ORDER.md")


def _parse(path: str) -> List[str]:
    # A missing ORDER.md (e.g. an install that dropped package data)
    # degrades to an empty ranking — every lock is unranked, the rank
    # check is a no-op, and the package stays importable. A present but
    # unparseable ORDER.md is a config error and still raises.
    if not os.path.exists(path):
        return []
    names: List[str] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            m = _ITEM_RE.match(line)
            if m and m.group(1) not in names:
                names.append(m.group(1))
    if not names:
        raise RuntimeError(
            f"no lock-order entries parsed from {path}; ORDER.md must "
            "contain a numbered list of `LockName` items")
    return names


#: lock names, outermost first — acquiring ``CANONICAL_LOCK_ORDER[i]``
#: while holding ``CANONICAL_LOCK_ORDER[j]`` requires ``j < i``
CANONICAL_LOCK_ORDER: List[str] = _parse(order_path())

#: name → rank (0 = outermost); names absent from ORDER.md are unranked
LOCK_RANKS: Dict[str, int] = {n: i for i, n in
                              enumerate(CANONICAL_LOCK_ORDER)}


def rank_of(name: Optional[str]) -> Optional[int]:
    """The canonical rank of ``name`` (None when unnamed/unranked)."""
    if name is None:
        return None
    return LOCK_RANKS.get(name)
