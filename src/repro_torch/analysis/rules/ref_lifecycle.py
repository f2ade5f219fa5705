"""ref-lifecycle: DeviceRef ownership bugs, linearly approximated.

DeviceRefs are linear-ish resources: ``donate()`` and ``release()`` end
a name's ownership, ``emit="ref"`` replies transfer it to the caller,
and pickling device-resident payloads silently drags arrays through
host memory unless they were ``spill()``-ed first. A cache leak on the
shed path and the speculative-loser reclaim both came from exactly
these shapes.

The rule tracks, per function, names bound to ref-creating
expressions — ``DeviceRef(...)``, ``DeviceRef.put(...)``,
``x.restrict(...)``, ``x.spill_copy(...)``, ``tree_wrap(...)``, and
``w.ask(...)`` where ``w`` was spawned with ``emit="ref"`` in the same
function — then applies a *linear per-block* approximation (each
statement list is scanned in order; branches are independent; no
inter-procedural flow):

* **use-after-donate / use-after-release** — a name is read after a
  statement-level ``name.donate()`` / ``name.release()`` in the same
  block, without an intervening rebinding. Includes double release.
* **unreleased-ref** — a ref-bound name that is *never used again* in
  the function: not released, donated, spilled, returned, yielded,
  passed anywhere, stored anywhere. Dropping a live ref on the floor
  leans on the GC finalizer for device memory — make the release
  explicit or route it through ``tree_release``.
* **pickle-without-spill** — ``pickle.dumps(name)`` / ``dump(name,…)``
  on a tracked ref with no ``name.spill()`` earlier in the block.

False-positive escape hatch as everywhere: ``# lint: <reason>`` on the
flagged line.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from ..lint import Finding, ModuleInfo, ProjectContext

_CREATORS = {"tree_wrap"}
_METHOD_CREATORS = {"restrict", "spill_copy", "put"}
_ENDERS = {"donate", "release"}


def _is_ref_creator(call: ast.Call, emit_ref_actors: Set[str]) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id == "DeviceRef" or f.id in _CREATORS
    if isinstance(f, ast.Attribute):
        if f.attr in _METHOD_CREATORS:
            # DeviceRef.put / ref.restrict / ref.spill_copy
            return True
        if f.attr == "ask" and isinstance(f.value, ast.Name) and \
                f.value.id in emit_ref_actors:
            return True
    return False


def _spawn_emits_ref(call: ast.Call) -> bool:
    if not isinstance(call.func, (ast.Name, ast.Attribute)):
        return False
    name = call.func.id if isinstance(call.func, ast.Name) else \
        call.func.attr
    if name not in ("spawn", "spawn_remote", "spawn_pool"):
        return False
    for kw in call.keywords:
        if kw.arg == "emit" and isinstance(kw.value, ast.Constant) and \
                kw.value.value == "ref":
            return True
    return False


def _names_loaded(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _assigned_names(stmt: ast.stmt) -> Set[str]:
    out: Set[str] = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) and \
            isinstance(stmt.target, ast.Name):
        out.add(stmt.target.id)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)) and \
            isinstance(stmt.target, ast.Name):
        out.add(stmt.target.id)
    return out


def _stmt_blocks(fn: ast.AST) -> Iterable[List[ast.stmt]]:
    """Every statement list in ``fn`` (function body, if/else arms,
    loop bodies, with bodies, handlers) — each analyzed independently."""
    for node in ast.walk(fn):
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(node, attr, None)
            if isinstance(block, list) and block and \
                    isinstance(block[0], ast.stmt):
                yield block


def _method_call_on(stmt: ast.stmt, methods: Set[str]):
    """(name, method) when ``stmt`` is exactly ``name.method(...)``."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        f = stmt.value.func
        if isinstance(f, ast.Attribute) and f.attr in methods and \
                isinstance(f.value, ast.Name):
            return f.value.id, f.attr
    return None


def _escapes(fn: ast.AST, name: str) -> bool:
    """Whether ``name`` is consumed, transferred, or stored anywhere in
    ``fn`` — conservatively broad, so unreleased-ref only fires on refs
    that are bound and then *never mentioned again*."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == name and \
                isinstance(node.ctx, ast.Load):
            return True
    return False


def rule_ref_lifecycle(mod: ModuleInfo, ctx: ProjectContext,
                       ) -> Iterable[Finding]:
    out: List[Finding] = []
    funcs = [n for n in ast.walk(mod.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        emit_ref_actors: Set[str] = set()
        ref_names: Dict[str, int] = {}   # name -> binding line
        # pass 1: what names hold refs / emit="ref" actor handles
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                if _spawn_emits_ref(node.value):
                    emit_ref_actors.add(tgt)
                elif _is_ref_creator(node.value, emit_ref_actors):
                    ref_names.setdefault(tgt, node.lineno)
        if not ref_names:
            continue
        qual = mod.qualname_of(fn)

        # pass 2: linear per-block scan for ordering bugs
        for block in _stmt_blocks(fn):
            dead: Dict[str, str] = {}      # name -> how it died
            spilled: Set[str] = set()
            for stmt in block:
                ender = _method_call_on(stmt, _ENDERS)
                spill = _method_call_on(stmt, {"spill"})
                loads = _names_loaded(stmt)
                # uses *before* this statement's own kill takes effect
                for name, how in list(dead.items()):
                    if name in loads and not mod.is_suppressed(stmt.lineno):
                        out.append(Finding(
                            path=mod.path, relpath=mod.relpath,
                            rule="ref-lifecycle", line=stmt.lineno,
                            qualname=qual,
                            detail=f"use-after-{how}:{name}",
                            message=(f"ref {name!r} used after "
                                     f"`{name}.{how}()` — ownership "
                                     "already ended; the backing buffer "
                                     "may be reused or freed"),
                        ))
                        del dead[name]   # one report per death
                for name in _assigned_names(stmt):
                    dead.pop(name, None)
                    spilled.discard(name)
                if spill and spill[0] in ref_names:
                    spilled.add(spill[0])
                if ender and ender[0] in ref_names:
                    dead[ender[0]] = ender[1]
                # pickle-without-spill
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    f = node.func
                    is_pickle = (
                        isinstance(f, ast.Attribute) and
                        f.attr in ("dumps", "dump") and
                        isinstance(f.value, ast.Name) and
                        f.value.id == "pickle")
                    if not is_pickle or not node.args:
                        continue
                    arg = node.args[0]
                    if isinstance(arg, ast.Name) and \
                            arg.id in ref_names and \
                            arg.id not in spilled and \
                            not mod.is_suppressed(node.lineno):
                        out.append(Finding(
                            path=mod.path, relpath=mod.relpath,
                            rule="ref-lifecycle", line=node.lineno,
                            qualname=qual,
                            detail=f"pickle-without-spill:{arg.id}",
                            message=(f"pickling ref {arg.id!r} without a "
                                     f"preceding `{arg.id}.spill()` drags "
                                     "the device payload through host "
                                     "memory implicitly"),
                        ))

        # pass 3: refs bound and never mentioned again
        for name, lineno in ref_names.items():
            if _escapes(fn, name):
                continue
            if mod.is_suppressed(lineno):
                continue
            out.append(Finding(
                path=mod.path, relpath=mod.relpath,
                rule="ref-lifecycle", line=lineno, qualname=qual,
                detail=f"unreleased-ref:{name}",
                message=(f"ref {name!r} is created and never used, "
                         "released, or donated — device memory is held "
                         "until the GC finalizer runs; release it "
                         "explicitly or drop the binding"),
            ))
    return out
