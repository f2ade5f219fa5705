"""blocking-call-in-behavior: no sleeping/joining inside actor code.

An actor behavior runs on a scheduler worker (or a drain loop borrowed
from the sender via ``try_call_inline``); blocking it stalls every
message behind it and — as a node's heartbeat hang once showed — can
wedge shutdown entirely when the blocked call never wakes to observe the
closed flag. The enforced style is event-driven waiting
(``Event.wait(timeout)``, future callbacks via ``add_done_callback``),
never ``time.sleep``, ``Future.result()``, or a synchronous
``ref.ask()`` from inside a behavior.

What counts as a *behavior* (the places this rule looks inside):

* functions passed positionally to ``spawn`` / ``spawn_remote`` /
  ``spawn_pool`` (either a name bound to a ``def`` in the same module,
  or an inline ``lambda``),
* ``receive`` methods of classes whose base-class name contains
  ``Actor``,
* inner functions returned by ``make_*`` behavior factories,
* ``threading.Thread(target=...)`` targets — runtime service loops
  share the same contract: they must wake up for shutdown.

Suppress a deliberate block with ``# lint: <reason>`` on the call line.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from ..lint import Finding, ModuleInfo, ProjectContext

_SPAWNERS = {"spawn", "spawn_remote", "spawn_pool"}


def _callee_name(func: ast.expr) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _collect_defs(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every def/lambda-bound name in the module (all scopes — a lint
    resolves names by best effort, not full scoping)."""
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
        elif isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Lambda):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    defs.setdefault(tgt.id, []).append(node.value)
    return defs


def _behavior_nodes(mod: ModuleInfo) -> Dict[ast.AST, str]:
    """AST nodes (FunctionDef or Lambda) that are actor behaviors,
    mapped to the reason they qualify."""
    defs = _collect_defs(mod.tree)
    behaviors: Dict[ast.AST, str] = {}

    def mark_name(name: str, why: str) -> None:
        for d in defs.get(name, ()):
            behaviors.setdefault(d, why)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            callee = _callee_name(node.func)
            if callee in _SPAWNERS:
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        mark_name(arg.id, f"passed to {callee}()")
                    elif isinstance(arg, ast.Lambda):
                        behaviors.setdefault(arg, f"passed to {callee}()")
            elif callee == "Thread":
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    v = kw.value
                    if isinstance(v, ast.Name):
                        mark_name(v.id, "Thread target")
                    elif isinstance(v, ast.Attribute):
                        mark_name(v.attr, "Thread target")
                    elif isinstance(v, ast.Lambda):
                        behaviors.setdefault(v, "Thread target")
        elif isinstance(node, ast.ClassDef):
            if any("Actor" in _callee_name(b) for b in node.bases):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) and \
                            item.name == "receive":
                        behaviors.setdefault(
                            item, f"{node.name}.receive behavior")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("make_"):
            returned: Set[str] = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return):
                    if isinstance(sub.value, ast.Name):
                        returned.add(sub.value.id)
                    elif isinstance(sub.value, ast.Lambda):
                        behaviors.setdefault(
                            sub.value, f"returned by factory {node.name}()")
            for item in ast.walk(node):
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        item is not node and item.name in returned:
                    behaviors.setdefault(
                        item, f"returned by factory {node.name}()")
    return behaviors


def _blocking_pattern(call: ast.Call) -> str:
    """'' or the stable pattern name of a blocking call."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr == "sleep" and isinstance(f.value, ast.Name) and \
                f.value.id == "time":
            return "time.sleep"
        if f.attr == "result":
            return ".result()"
        if f.attr == "ask":
            return ".ask()"
    elif isinstance(f, ast.Name) and f.id == "sleep":
        return "time.sleep"
    return ""


def rule_blocking_call(mod: ModuleInfo, ctx: ProjectContext,
                       ) -> Iterable[Finding]:
    out: List[Finding] = []
    for fn, why in _behavior_nodes(mod).items():
        fn_name = getattr(fn, "name", "<lambda>")
        if mod.is_suppressed(fn.lineno):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            pattern = _blocking_pattern(node)
            if not pattern:
                continue
            if mod.is_suppressed(node.lineno):
                continue
            qual = mod.qualname_of(fn)
            if qual == "<module>":
                qual = fn_name
            out.append(Finding(
                path=mod.path, relpath=mod.relpath,
                rule="blocking-call-in-behavior",
                line=node.lineno, qualname=qual,
                detail=pattern,
                message=(f"`{pattern}` inside {fn_name!r} ({why}) blocks "
                         "the scheduler thread running this behavior — "
                         "use Event.wait(timeout)/add_done_callback, or "
                         "tag with `# lint: <reason>` if deliberate"),
            ))
    return out
