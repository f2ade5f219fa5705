"""lock-order: static acquisition-order graph from nested ``with``.

The prepass harvests two cross-module facts:

1. **Lock names** — assignments of the form
   ``self.ATTR = make_lock("Name")`` / ``make_rlock("Name")`` (the
   seam every runtime module constructs its locks through), plus plain
   ``threading.Lock()/RLock()`` sites, which get the synthesized name
   ``Class.ATTR``. ``self.CV = threading.Condition(self.LOCK)`` aliases
   the condition attribute to its underlying lock's name.
2. **Nesting edges** — syntactically nested ``with self.X:`` blocks
   whose context expressions resolve to known locks. (The static view
   only sees lexical nesting; the dynamic ``TrackedLock`` graph covers
   nesting through calls.)

The rule then reports, per module:

* **rank inversions** — an edge ``outer → inner`` where ``ORDER.md``
  ranks ``inner`` *above* ``outer`` (the inner acquisition should have
  come first), and
* **cycles** — strongly-connected knots in the global edge graph,
  reported once, on the module owning the cycle's first edge.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..lint import Finding, ModuleInfo, ProjectContext
from ..order import rank_of

# edge: (outer_name, inner_name, relpath, path, line, qualname)
Edge = Tuple[str, str, str, str, int, str]


def _lock_name_from_call(call: ast.Call, cls: str, attr: str,
                         ) -> Optional[str]:
    f = call.func
    callee = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    if callee in ("make_lock", "make_rlock"):
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            return call.args[0].value
        return f"{cls}.{attr}" if cls else attr
    if callee in ("Lock", "RLock"):
        return f"{cls}.{attr}" if cls else attr
    return None


def _harvest_module(mod: ModuleInfo) -> Dict[Tuple[str, str], str]:
    """(class_name, attr) -> lock name for this module; module-level
    locks use class_name ''. Conditions alias their wrapped lock."""
    table: Dict[Tuple[str, str], str] = {}

    def scan(node: ast.AST, cls: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan(child, child.name)
                continue
            if isinstance(child, ast.Assign) and \
                    isinstance(child.value, ast.Call) and \
                    len(child.targets) == 1:
                tgt = child.targets[0]
                attr = None
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    attr = tgt.attr
                elif isinstance(tgt, ast.Name):
                    attr = tgt.id
                if attr is not None:
                    name = _lock_name_from_call(child.value, cls, attr)
                    if name is not None:
                        table[(cls, attr)] = name
                    else:
                        # Condition(self._lock) aliases to the lock
                        f = child.value.func
                        callee = f.id if isinstance(f, ast.Name) else (
                            f.attr if isinstance(f, ast.Attribute) else "")
                        if callee == "Condition" and child.value.args:
                            a0 = child.value.args[0]
                            if isinstance(a0, ast.Attribute) and \
                                    isinstance(a0.value, ast.Name) and \
                                    a0.value.id == "self" and \
                                    (cls, a0.attr) in table:
                                table[(cls, attr)] = table[(cls, a0.attr)]
            scan(child, cls)

    scan(mod.tree, "")
    return table


def _resolve(expr: ast.expr, cls: str,
             table: Dict[Tuple[str, str], str]) -> Optional[str]:
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return table.get((cls, expr.attr))
    if isinstance(expr, ast.Name):
        return table.get(("", expr.id))
    return None


def _enclosing_class(mod: ModuleInfo, fn: ast.AST) -> str:
    qual = mod.qualname_of(fn)
    return qual.split(".")[0] if "." in qual else ""


def prepass_lock_order(ctx: ProjectContext) -> None:
    tables: Dict[str, Dict[Tuple[str, str], str]] = {}
    for mod in ctx.modules:
        t = _harvest_module(mod)
        tables[mod.relpath] = t
        for (cls, attr), name in t.items():
            ctx.lock_names[f"{mod.relpath}::{cls}::{attr}"] = name

    edges: List[Edge] = []
    for mod in ctx.modules:
        table = tables[mod.relpath]
        if not table:
            continue
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            cls = _enclosing_class(mod, fn)
            qual = mod.qualname_of(fn)

            def walk(node: ast.AST, held: List[Tuple[str, int]]) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        continue   # nested defs run later, not here
                    if isinstance(child, ast.With):
                        acquired: List[Tuple[str, int]] = []
                        for item in child.items:
                            name = _resolve(item.context_expr, cls, table)
                            if name is None:
                                continue
                            for outer, _ in held + acquired:
                                if outer != name and not \
                                        mod.is_suppressed(child.lineno):
                                    edges.append((
                                        outer, name, mod.relpath,
                                        mod.path, child.lineno, qual))
                            acquired.append((name, child.lineno))
                        walk(child, held + acquired)
                    else:
                        walk(child, held)

            walk(fn, [])
    ctx.lock_edges = edges   # type: ignore[attr-defined]


def _find_cycles(edges: List[Edge]) -> List[List[str]]:
    adj: Dict[str, Set[str]] = {}
    for a, b, *_ in edges:
        adj.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen_sets = set()
    for start in adj:
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append(path + [start])
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return cycles


def rule_lock_order(mod: ModuleInfo, ctx: ProjectContext,
                    ) -> Iterable[Finding]:
    edges: List[Edge] = getattr(ctx, "lock_edges", [])
    out: List[Finding] = []
    mine = [e for e in edges if e[2] == mod.relpath]
    for outer, inner, _rel, path, line, qual in mine:
        ro, ri = rank_of(outer), rank_of(inner)
        if ro is not None and ri is not None and ri < ro:
            out.append(Finding(
                path=path, relpath=mod.relpath, rule="lock-order",
                line=line, qualname=qual,
                detail=f"inversion:{outer}->{inner}",
                message=(f"acquires {inner!r} (rank {ri}) while holding "
                         f"{outer!r} (rank {ro}); ORDER.md ranks "
                         f"{inner!r} as the outer lock — invert the "
                         "nesting or update ORDER.md"),
            ))
    # report each global cycle once, on the module owning its first edge
    for cycle in _find_cycles(edges):
        pairs = list(zip(cycle, cycle[1:]))
        sites = [e for e in edges if (e[0], e[1]) in pairs]
        if not sites:
            continue
        first = min(sites, key=lambda e: (e[2], e[4]))
        if first[2] != mod.relpath:
            continue
        out.append(Finding(
            path=first[3], relpath=mod.relpath, rule="lock-order",
            line=first[4], qualname=first[5],
            detail="cycle:" + "->".join(sorted(set(cycle))),
            message=("lock acquisition cycle "
                     f"{' -> '.join(cycle)} — two threads entering "
                     "from different points deadlock"),
        ))
    return out
