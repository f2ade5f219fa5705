"""Rule registry for ``repro_torch.analysis``.

A rule is ``rule(module: ModuleInfo, ctx: ProjectContext) ->
Iterable[Finding]``; register it in :data:`ALL_RULES` under its slug.
A *prepass* is ``prepass(ctx) -> None`` and runs once per lint
invocation before any rule, for cross-module fact gathering (the
lock-order rule uses one to harvest lock names and nesting edges from
every module before judging any single one).
"""
from __future__ import annotations

from .blocking_call import rule_blocking_call
from .lock_order import prepass_lock_order, rule_lock_order
from .ref_lifecycle import rule_ref_lifecycle
from .silent_except import rule_silent_except

ALL_RULES = {
    "ref-lifecycle": rule_ref_lifecycle,
    "blocking-call-in-behavior": rule_blocking_call,
    "silent-except": rule_silent_except,
    "lock-order": rule_lock_order,
}

PREPASSES = [prepass_lock_order]

__all__ = ["ALL_RULES", "PREPASSES"]
