"""AST lint framework for the actor runtime — a copy of the JAX
package's ``repro/analysis/lint.py``, so the port lints itself without
importing that package.

The runtime's concurrency and DeviceRef-lifecycle contracts (no
blocking calls inside actor behaviors, every ``emit="ref"`` result
released on every path, locks taken in the ``ORDER.md`` order, no
silently-swallowed exceptions in broker/reader threads) used to live in
reviewers' heads, where races, leaks and deadlocks slipped past them.
This package machine-checks those contracts.

Architecture:

* :class:`Finding` — one diagnostic, with a *fingerprint* that is
  line-number-free (``relpath::rule::qualname::detail``) so baselines
  survive unrelated edits to the same file.
* :class:`ModuleInfo` — a parsed module handed to every rule: path,
  AST, raw source lines, and the set of ``# lint:``-suppressed lines.
* Rules are callables ``rule(module: ModuleInfo, ctx: ProjectContext)
  -> Iterable[Finding]`` registered in ``repro_torch.analysis.rules``.
  ``ProjectContext`` carries cross-module facts (today: the lock-name
  table the lock-order rule builds in a first pass).
* Baseline files hold one fingerprint per line; a run fails (exit 1)
  only on findings *not* in the baseline. Stale baseline entries are a
  warning, not an error — deleting an entry after fixing its finding
  is the normal workflow (and deleting one whose finding still exists
  makes the run fail, which is what CI relies on).

Suppression: append ``# lint: <reason>`` to the offending line (or the
``except``/``with``/``def`` line introducing the construct). Reasons are
mandatory by convention — a bare tag reads as unexplained and reviewers
should push back.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "ProjectContext",
    "collect_modules",
    "run_rules",
    "fingerprints",
    "load_baseline",
    "write_baseline",
    "compare",
]

SUPPRESS_TAG = "# lint:"


@dataclass
class Finding:
    path: str          # path as given on the command line
    relpath: str       # repo-relative, '/'-separated — the stable key
    rule: str          # rule slug, e.g. "silent-except"
    line: int          # 1-based, for humans; not part of the fingerprint
    qualname: str      # enclosing Class.func dotted path ("<module>" at top level)
    detail: str        # rule-specific stable discriminator
    message: str       # human-readable explanation

    def fingerprint(self) -> str:
        return f"{self.relpath}::{self.rule}::{self.qualname}::{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"  ({self.qualname})")


@dataclass
class ModuleInfo:
    path: str
    relpath: str
    tree: ast.Module
    lines: List[str]                      # raw source, 0-indexed
    suppressed: frozenset                 # 1-based line numbers with a lint tag

    def is_suppressed(self, *linenos: int) -> bool:
        return any(n in self.suppressed for n in linenos)

    def qualname_of(self, node: ast.AST) -> str:
        """Dotted Class.func path enclosing ``node`` (computed once,
        cached on the module)."""
        parents = getattr(self, "_qualnames", None)
        if parents is None:
            parents = {}
            def walk(n, prefix):
                for child in ast.iter_child_nodes(n):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        q = f"{prefix}.{child.name}" if prefix else child.name
                        parents[child] = q
                        walk(child, q)
                    else:
                        parents[child] = prefix
                        walk(child, prefix)
            walk(self.tree, "")
            self._qualnames = parents
        return parents.get(node) or "<module>"


@dataclass
class ProjectContext:
    """Cross-module facts shared by all rules over one run."""
    modules: List[ModuleInfo] = field(default_factory=list)
    # (relpath-agnostic) lock attribute name -> canonical lock name,
    # harvested from make_lock("Name") / make_rlock("Name") call sites
    # by the lock-order rule's prepass; e.g. "_lock@PagePool" -> "PagePool"
    lock_names: Dict[str, str] = field(default_factory=dict)


def _suppressed_lines(lines: Sequence[str]) -> frozenset:
    return frozenset(i + 1 for i, ln in enumerate(lines)
                     if SUPPRESS_TAG in ln)


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                # build trees and egg-info hold stale copies of the
                # package — linting them would shadow real findings with
                # duplicates from snapshots nobody edits
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "build", "dist")
                    and not d.endswith(".egg-info"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def _relpath(path: str, root: Optional[str]) -> str:
    ap = os.path.abspath(path)
    if root:
        try:
            rp = os.path.relpath(ap, root)
            if not rp.startswith(".."):
                return rp.replace(os.sep, "/")
        except ValueError:
            pass
    return os.path.basename(ap)


def _repo_root(start: str) -> Optional[str]:
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, ".git")) or \
           os.path.isfile(os.path.join(cur, "pyproject.toml")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return None
        cur = parent


def collect_modules(paths: Sequence[str]) -> Tuple[List[ModuleInfo], List[str]]:
    """Parse every ``.py`` under ``paths``. Returns (modules, errors);
    unparseable files become error strings, not crashes."""
    modules: List[ModuleInfo] = []
    errors: List[str] = []
    root = _repo_root(paths[0]) if paths else None
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError) as exc:
            errors.append(f"{path}: cannot analyze: {exc}")
            continue
        lines = src.splitlines()
        modules.append(ModuleInfo(
            path=path,
            relpath=_relpath(path, root),
            tree=tree,
            lines=lines,
            suppressed=_suppressed_lines(lines),
        ))
    return modules, errors


Rule = Callable[[ModuleInfo, ProjectContext], Iterable[Finding]]


def run_rules(paths: Sequence[str],
              rules: Optional[Dict[str, Rule]] = None,
              ) -> Tuple[List[Finding], List[str]]:
    """Run every registered rule over every module under ``paths``."""
    if rules is None:
        from .rules import ALL_RULES
        rules = ALL_RULES
    modules, errors = collect_modules(paths)
    ctx = ProjectContext(modules=modules)
    # prepass hooks (cross-module fact gathering) run before any rule
    from .rules import PREPASSES
    for prepass in PREPASSES:
        prepass(ctx)
    findings: List[Finding] = []
    for mod in modules:
        for name, rule in rules.items():
            try:
                findings.extend(rule(mod, ctx))
            except Exception as exc:
                errors.append(f"{mod.path}: rule {name} crashed: {exc!r}")
    findings.sort(key=lambda f: (f.relpath, f.line, f.rule, f.detail))
    return findings, errors


def fingerprints(findings: Iterable[Finding]) -> List[str]:
    """Stable, deduplicated fingerprints; repeats of the same print get
    ``#2``, ``#3``… suffixes so a baseline holds exactly one line per
    live finding."""
    seen: Dict[str, int] = {}
    out: List[str] = []
    for f in findings:
        fp = f.fingerprint()
        n = seen.get(fp, 0) + 1
        seen[fp] = n
        out.append(fp if n == 1 else f"{fp}#{n}")
    return out


def load_baseline(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        return [ln.strip() for ln in fh
                if ln.strip() and not ln.lstrip().startswith("#")]


def write_baseline(path: str, findings: Iterable[Finding]) -> int:
    fps = fingerprints(findings)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# repro_torch.analysis baseline — one fingerprint per "
                 "accepted pre-existing finding.\n"
                 "# Fix the finding, then delete its line. Adding lines "
                 "to silence new findings defeats the gate;\n"
                 "# prefer a `# lint: <reason>` tag at the site so the "
                 "reason lives next to the code.\n")
        for fp in fps:
            fh.write(fp + "\n")
    return len(fps)


def compare(findings: Sequence[Finding], baseline: Sequence[str],
            ) -> Tuple[List[Finding], List[str]]:
    """(new findings not in baseline, stale baseline entries)."""
    fps = fingerprints(findings)
    base = set(baseline)
    new = [f for f, fp in zip(findings, fps) if fp not in base]
    live = set(fps)
    stale = [b for b in baseline if b not in live]
    return new, stale
