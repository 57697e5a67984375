"""Small cells for the CPU tests: a copy of the benchmark's files under a
temporary directory, with the configurations cut to a size the CPU runs
in a second or two."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from cellbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "cellbench"
SMALL = {
    "rgg_2e20": {"n": 1 << 12, "buffcut": {"k": 8, "batch_size": 512, "buffer_size": 2048}},
    "rmat_2e19": {"scale": 10, "buffcut": {"k": 8, "batch_size": 256, "buffer_size": 1024}},
}


def small_bench(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and cellbench/{configs,traffic,metrics} under
    `tmp`, every configuration cut to its SMALL size; returns the bench dir."""
    bench = tmp / "cellbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec_ = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec_["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        for key, val in SMALL[c["name"]].items():
            if isinstance(val, dict):
                cfg[key] = {**cfg[key], **val}
            else:
                cfg[key] = val
        cfg["multilevel"]["device"] = "cpu"
        path.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec_))
    return bench


def small_cell(tmp: Path, workload: str):
    bench = small_bench(tmp)
    return spec.load_cell(tmp / "BENCHMARK.json", workload, bench)
