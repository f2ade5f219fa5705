"""silent-except: broad handlers that swallow errors without a trace.

Flags ``except:``, ``except Exception:`` and ``except BaseException:``
handlers whose body does nothing but ``pass``/``continue``/``...`` —
the pattern that hid real faults in the net broker and reader threads
(a decode error, a half-closed socket, a failed scale action) until
someone attached a debugger. A handler stops being silent the moment it
logs, re-raises, counts, or annotates; a handler that *must* stay
silent gets a ``# lint: <reason>`` tag on the ``except`` line so the
justification lives next to the code.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from ..lint import Finding, ModuleInfo, ProjectContext

_BROAD = ("Exception", "BaseException")


def _handler_kind(h: ast.ExceptHandler) -> str:
    """'bare', 'Exception', 'BaseException' for broad handlers; '' for
    narrow ones (which are allowed to be quiet — catching a specific
    exception is itself a statement of intent)."""
    if h.type is None:
        return "bare"
    t = h.type
    if isinstance(t, ast.Name) and t.id in _BROAD:
        return t.id
    if isinstance(t, ast.Attribute) and t.attr in _BROAD:
        return t.attr
    return ""


def _is_noop(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Pass, ast.Continue)):
        return True
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True   # docstring or bare `...`
    return False


def rule_silent_except(mod: ModuleInfo, ctx: ProjectContext,
                       ) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        kind = _handler_kind(node)
        if not kind:
            continue
        if not all(_is_noop(s) for s in node.body):
            continue
        body_lines = [node.lineno] + [s.lineno for s in node.body]
        if mod.is_suppressed(*body_lines):
            continue
        out.append(Finding(
            path=mod.path, relpath=mod.relpath, rule="silent-except",
            line=node.lineno, qualname=mod.qualname_of(node),
            detail=kind,
            message=(f"broad `except {kind if kind != 'bare' else ''}"
                     f"{':' if kind == 'bare' else ':'}` swallows the "
                     "error with no log, counter, or re-raise — note it "
                     "somewhere observable or tag the line with "
                     "`# lint: <reason>`").replace("except :", "except:"),
        ))
    return out
