"""What the benchmark may load: no module under cellbench/ imports JAX or
the JAX package `repro`, and the plain reference imports nothing of the
program (`repro_torch`) and no torch.  Names are compared by their top
level, the part before the first dot, as a whole: `repro_torch` is not
`repro`."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from cellbench import run as bench_run
from cellbench.tests._cells import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path) -> set:
    """Top-level names of every module that `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.api\nfrom repro_torch import x\nimport jaxtyping\n")
    assert imported(f) == {"repro_torch", "jaxtyping"} and not imported(f) & BANNED
    f.write_text("from repro.core import y\nimport jax.numpy as jnp\n")
    assert imported(f) == {"repro", "jax"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "numpy", "cellbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("cellbench"):
            assert node.module.startswith("cellbench.reference")


def test_banned_modules_reads_whole_top_level_names():
    assert bench_run.banned_modules(["repro_torch.api", "jaxtyping", "os", "reprox"]) == []
    assert bench_run.banned_modules(["repro_torch", "jaxlib.xla", "repro.core", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_a_runs_imports_hold_no_jax():
    """The harness, the program's front door and the reference loaded in a
    fresh interpreter leave no JAX and no `repro` in sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import cellbench.run as r, cellbench.harness.graphs, cellbench.harness.trace\n"
        "import cellbench.reference.heistream, cellbench.control\n"
        "import repro_torch.api, repro_torch.core.multilevel_torch\n"
        "print(r.banned_modules())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_directory_without_the_program_fails(tmp_path):
    """Only BENCHMARK.json and cellbench/: a run exits non-zero and prints no
    result line, from the command (it stops at the look for a card, or
    where there is one at the program's import) and past that look."""
    import os
    import shutil

    shutil.copytree(BENCH, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cli = [sys.executable, "cellbench/run.py", "--workload", "rgg_2e20.heistream",
           "--seed", "1", "--seconds", "1"]
    past_card = [sys.executable, "-c",
                 "import sys, pathlib; sys.path.insert(0, '.')\n"
                 "from cellbench import run\nfrom cellbench.harness import spec\n"
                 "cell = spec.load_cell(pathlib.Path('BENCHMARK.json'), 'rgg_2e20.heistream')\n"
                 "print(run.run(cell, 1, 1.0, False, device='cpu'))\n"]
    for cmd in (cli, past_card):
        out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert "correct" not in out.stdout
    assert "repro_torch" in out.stderr
