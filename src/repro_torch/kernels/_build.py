"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C entry point.  At first
use it is compiled for sm_90a into `build/repro_torch/<name>-<hash>.so` at
the root of the checkout (a directory `.gitignore` lists), keyed by a hash
of the source and the flags, and loaded once per process.  `build_all`
starts one nvcc per source at once, so a cold start pays for the slowest
kernel, not the sum.  One lock serializes `build_all` and `load` across
the threads of a process (the temporary file is named by process, and
threads that build one library would share it).  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ell_histogram", "swa_attention", "embedding_bag", "fennel_gain")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: tuple[str, ...] = SOURCES) -> float:
    """Compile every missing kernel library in parallel; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [(name, *_start(name)) for name in names]
        for name, out, proc in started:
            _finish(name, out, proc)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for the cached library (ptxas register/spill report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
