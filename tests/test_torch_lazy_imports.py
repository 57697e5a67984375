"""The import contract of the partitioning path, paired with the reference:
importing a module of the partitioning path loads no accelerator stack —
no `jax` for `repro`, no `torch` for `repro_torch` — so CPU runs and
forked shard workers never pay or inherit it.  Each import runs in a
fresh interpreter.  The CLI's `list`, `gen` and `analyze` verbs run with
torch unimportable, and a process-backend shard run forks from a parent
that has not loaded torch."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}

#: (reference module, port module) on the partitioning path
PAIRS = [
    ("repro", "repro_torch"),
    ("repro.api", "repro_torch.api"),
    ("repro.api.cli", "repro_torch.api.cli"),
    ("repro.core", "repro_torch.core"),
    ("repro.core.buffcut", "repro_torch.core.buffcut"),
    ("repro.core.pipeline", "repro_torch.core.pipeline"),
    ("repro.core.vector_stream", "repro_torch.core.vector_stream"),
    ("repro.core.restream", "repro_torch.core.restream"),
    ("repro.core.heistream", "repro_torch.core.heistream"),
    ("repro.core.cuttana", "repro_torch.core.cuttana"),
    ("repro.core.fennel", "repro_torch.core.fennel"),
    ("repro.graphs", "repro_torch.graphs"),
    ("repro.distributed.shard_driver", "repro_torch.distributed.shard_driver"),
    ("repro.serve", "repro_torch.serve"),
    ("repro.launch.serve", "repro_torch.launch.serve"),
    ("repro.analysis", "repro_torch.analysis"),
]

#: makes `import torch` raise, as on a host without it
NO_TORCH = "import sys; sys.modules['torch'] = None\n"


def _run(code: str, timeout: float = 120, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env={**ENV, **env}, timeout=timeout)


def _loads(module: str, heavy: str) -> bool:
    out = _run(f"import sys, {module}\nprint({heavy!r} in sys.modules)\n")
    assert out.returncode == 0, out.stderr
    return out.stdout.split()[-1] == "True"


@pytest.mark.parametrize("ref,port", PAIRS, ids=[p for _, p in PAIRS])
def test_import_loads_no_accelerator_stack(ref, port):
    assert not _loads(ref, "jax"), f"{ref} imports jax"
    assert not _loads(port, "torch"), f"{port} imports torch"


@pytest.mark.parametrize("argv", [
    ["list", "-v"],
    ["analyze", "--format", "json"],
    ["gen", "grid", "-o", "{tmp}/mesh.bcsr", "--param", "side=8"],
    ["gen", "rmat", "-o", "{tmp}/rmat.metis", "--format", "metis",
     "--param", "n=64", "--param", "avg_degree=4"],
], ids=["list", "analyze", "gen-packed", "gen-metis"])
def test_cli_verbs_run_without_torch(argv, tmp_path):
    argv = [a.format(tmp=tmp_path) for a in argv]
    code = NO_TORCH + (
        "import runpy\n"
        f"sys.argv = ['repro_torch', *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "else:\n"
        "    rc = 0\n"
        "print('RC', rc)\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["RC", "0"], out.stdout + out.stderr


def test_process_backend_forks_from_a_torch_free_parent():
    """The sparse engine's process backend: the parent loads no torch
    through a whole sharded run (the workers load what they need after
    the fork), and the labels equal the thread backend's."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.api import partition\n"
        "kw = dict(driver='buffcut', k=4, engine='sparse', device='cpu', workers=2)\n"
        "a = partition('gen:grid:side=32', shard_backend='process', **kw)\n"
        "print('torch' in sys.modules)\n"
        "b = partition('gen:grid:side=32', shard_backend='thread', **kw)\n"
        "print(np.array_equal(a.labels, b.labels))\n"
    )
    out = _run(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["False", "True"], out.stdout


def test_entry_points_still_default_to_the_card():
    """Lazy imports moved no default: with no card, the API and the CLI
    refuse a device engine before any work, and the launch server too
    (any card of the host is hidden from the child)."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from repro_torch.api import partition\n"
        "from repro_torch.api.cli import main\n"
        "from repro_torch.launch.serve import main as serve_main\n"
        "try:\n"
        "    partition('gen:grid:side=16', k=2)\n"
        "except RuntimeError as e:\n"
        "    print('api', 'no CUDA device' in str(e))\n"
        "print('cli', main(['partition', 'gen:grid:side=16', '-k', '2']))\n"
        "try:\n"
        "    serve_main(['--arch', 'partition', '--graph', 'gen:grid:side=16', '--k', '2'])\n"
        "except RuntimeError as e:\n"
        "    print('serve', 'no CUDA device' in str(e))\n"
    )
    out = _run(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["api", "True", "cli", "1", "serve", "True"], out.stdout
