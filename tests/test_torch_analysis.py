"""The port's AST linter (``repro_torch.analysis.lint`` and ``.rules``, a
copy of the JAX package's) against the JAX linter: the same findings,
fingerprint for fingerprint, on every fixture of ``tests/fixtures/lint``
and on ``src/repro``; ``tests/test_analysis.py``'s baseline and CLI
cases on the port's functions; and ``src/repro_torch`` clean with no
baseline file (its one accepted site carries a ``# lint:`` tag).
"""
import os
import subprocess
import sys

import pytest

from repro.analysis import lint as jax_lint
from repro_torch.analysis.lint import (compare, fingerprints, load_baseline,
                                       run_rules, write_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")


def _both(paths):
    got, errors = run_rules(paths)
    want, jax_errors = jax_lint.run_rules(paths)
    assert errors == jax_errors == []
    return got, want


@pytest.mark.parametrize("name", sorted(os.listdir(FIXTURES)))
def test_fixture_fingerprints_equal_the_jax_linters(name):
    got, want = _both([os.path.join(FIXTURES, name)])
    assert fingerprints(got) == jax_lint.fingerprints(want)
    assert [f.line for f in got] == [f.line for f in want]
    assert bool(got) == name.endswith("_bad.py")


def test_jax_package_fingerprints_equal_the_jax_linters():
    got, want = _both([os.path.join(REPO, "src", "repro")])
    assert fingerprints(got) == jax_lint.fingerprints(want)
    baseline = load_baseline(os.path.join(REPO, "analysis-baseline.txt"))
    assert compare(got, baseline)[0] == []


def test_the_port_is_clean_without_a_baseline():
    findings, errors = run_rules([os.path.join(REPO, "src", "repro_torch")])
    assert errors == []
    assert findings == [], [f.render() for f in findings]
    # the accepted blocking call carries its reason at the site
    with open(os.path.join(REPO, "src", "repro_torch", "serve",
                           "engine.py")) as fh:
        assert "step_graph.ask(  # lint: " in fh.read()


def test_baseline_roundtrip(tmp_path):
    findings, _ = run_rules([os.path.join(FIXTURES, "silent_except_bad.py")])
    bl = tmp_path / "baseline.txt"
    write_baseline(str(bl), findings)
    loaded = load_baseline(str(bl))
    assert loaded == fingerprints(findings)
    assert compare(findings, loaded) == ([], [])
    new, stale = compare(findings, loaded[1:])
    assert len(new) == 1 and stale == []
    new, stale = compare(findings[1:], loaded)
    assert new == [] and len(stale) == 1


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_ANALYSIS="")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_gate(tmp_path):
    """``tests/test_analysis.py::test_cli_gate`` on the port's CLI: the bad
    fixture fails, ``--write-baseline`` then passes, and deleting a
    baseline line fails again."""
    bad = os.path.join(FIXTURES, "silent_except_bad.py")
    bl = str(tmp_path / "bl.txt")
    assert _cli(bad).returncode == 1
    assert _cli(bad, "--baseline", bl, "--write-baseline").returncode == 0
    assert _cli(bad, "--baseline", bl).returncode == 0
    lines = open(bl).read().splitlines()
    open(bl, "w").write("\n".join(lines[:-1]) + "\n")
    assert _cli(bad, "--baseline", bl).returncode == 1


def test_cli_lints_the_port_by_default():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr
