"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.

A static walk follows every import statement (at any depth of a module,
so imports inside functions count) from ``benchmark.run``, every driver,
metric and reference module, through the modules of this repository, and
collects the top-level names (the part before the first dot) of everything
imported.  Names are compared whole: ``gnnkeras_tpu_torch`` is the port,
``gnnkeras_tpu`` the JAX package.  A run on the CPU then checks
``sys.modules`` the way the harness does after its window.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOCAL = ("benchmark", "gnnkeras_tpu_torch", "gnnkeras_tpu")
FORBIDDEN = {"jax", "jaxlib", "flax", "gnnkeras_tpu"}  # as the harness's own check (harness.FORBIDDEN)


def module_file(name):
    base = os.path.join(REPO, *name.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def imported(path, package):
    """The absolute names ``path`` imports (``package``: its package, for
    relative imports)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(parts + ([node.module] if node.module else []))
            else:
                base = node.module
            names.append(base)
            names += [f"{base}.{a.name}" for a in node.names]  # a submodule imported by name
    return names


def walk(files):
    """Top-level names reached from ``files`` ((path, package) pairs)."""
    tops, seen, todo = set(), set(), list(files)
    while todo:
        path, package = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in imported(path, package):
            top = name.split(".")[0]
            tops.add(top)
            if top in LOCAL:
                target = module_file(name)
                if target is not None:
                    pkg = name if target.endswith("__init__.py") else name.rpartition(".")[0]
                    todo.append((target, pkg))
    return tops


def benchmark_files(*folders):
    out = []
    for folder in folders:
        for path in glob.glob(os.path.join(REPO, "benchmark", folder, "*.py")):
            out.append((path, "benchmark." + folder if folder else "benchmark"))
    return out


def test_walk_sees_imports_inside_functions():
    tops = walk([(os.path.join(REPO, "benchmark", "drivers", "fit.py"), "benchmark.drivers")])
    assert "gnnkeras_tpu_torch" in tops and "torch" in tops


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    tops = walk([(os.path.join(REPO, "benchmark", "run.py"), "benchmark")]
                + benchmark_files("", "drivers", "metrics", "reference", "data"))
    assert "gnnkeras_tpu_torch" in tops  # the program under test
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


@pytest.mark.parametrize("folder", ["reference", "data"])
def test_reference_and_data_import_nothing_of_the_program(folder):
    tops = walk(benchmark_files(folder))
    assert "gnnkeras_tpu_torch" not in tops and not tops & FORBIDDEN, sorted(tops)
    assert tops <= {"__future__", "dataclasses", "typing", "torch", "numpy", "benchmark", "math"}, sorted(tops)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})\n"
        "from bench_toy import toy_root\n"
        "from benchmark import harness\n"
        "r = harness.run_cell(toy_root({root!r}), 'banded_gnn.fit_band64', 7, 0.2, False, 'cpu')\n"
        "assert r['correct'], r\n"
        "print('FOUND', harness.forbidden_modules())\n"
    ).format(repo=REPO, tests=os.path.dirname(__file__), root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    monkeypatch.setitem(sys.modules, "gnnkeras_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnnkeras_tpu.models", sys)
    assert harness.forbidden_modules() == ["gnnkeras_tpu"]
