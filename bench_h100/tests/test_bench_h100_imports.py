"""The import boundary: nothing under bench_h100/ imports jax, jaxlib, flax
or the JAX package ``repro`` (top-level names compared whole, so
``repro_torch`` is not ``repro``); the reference imports nothing of the
program; nothing reads ``benchmarks/``."""
import ast
import os


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_top_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        mods = set(_top_imports(p))
        assert not mods & (FORBIDDEN | {"repro_torch", "bench_h100"}), p


def test_nothing_reads_the_old_benchmarks_folder():
    for p in _sources():
        if "tests" in p.split(os.sep):
            continue
        assert "benchmarks/" not in open(p).read(), p


def test_runtime_check_compares_whole_names():
    from bench_h100.harness import forbidden_modules
    assert forbidden_modules({"repro_torch": 0, "repro_torch.models": 0,
                              "bench_h100": 0, "jaxtyping": 0}) == []
    assert forbidden_modules({"repro.core": 0, "jax.numpy": 0, "flax": 0,
                              "jaxlib": 0}) == ["flax", "jax", "jaxlib",
                                                "repro"]
