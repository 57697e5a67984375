"""The control of the comparison that decides `correct`, at a cell's own size.

    python cellbench/control.py --workload rgg_2e20.heistream --seeds 11 12 13

For each seed the cell's graph is made as a run makes it, and the plain
reference is put in the program's place with one guarantee of the
configuration broken: its V-cycle schedule, one refinement round a level
fewer (`rounds`), or its balance cap L_max lifted (`cap`).  The
configuration's `control` names the break that is its control.
The labels are judged as a run's are, against the sound reference; each
seed and break prints one JSON line of the compared numbers.  The
control has to fail: `label_mismatch` above its limit.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BREAKS = ("rounds", "cap")


def control(cell, seed: int, device: str, breaks=BREAKS) -> list:
    import numpy as np

    from cellbench.harness import graphs, judge, spec

    tr = cell.traffic
    reference = spec.reference(tr["driver"])
    graph = graphs.stream_order(graphs.make_graph(cell.config, seed, device), tr["order"],
                                seed, device)
    part, ml = cell.config["buffcut"], cell.config["multilevel"]
    want = reference.partition(graph, part, ml)
    k = int(part["k"])
    cap = reference.l_max(float(graph.node_w.astype(np.float64).sum()), k, float(part["eps"]))
    out = []
    for brk in breaks:
        t0 = time.perf_counter()
        if brk == "rounds":
            got = reference.partition(graph, part, {**ml, "refine_rounds": ml["refine_rounds"] - 1})
        else:
            got = reference.partition(graph, part, ml, cap=math.inf)
        checks, failed = judge.judge(graph, want, [(got, judge.edge_cut(graph, got))], k, cap)
        out.append({"workload": cell.name, "seed": seed, "break": brk, "failed": failed,
                    "seconds": time.perf_counter() - t0,
                    "checks": {n: c["value"] for n, c in checks.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--breaks", nargs="+", choices=BREAKS,
                    help="the guarantees to break (default: the configuration's control)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from cellbench.harness import spec

    cell = spec.load_cell(ROOT / "BENCHMARK.json", args.workload)
    for seed in args.seeds:
        for line in control(cell, seed, args.device, args.breaks or [cell.config["control"]]):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
