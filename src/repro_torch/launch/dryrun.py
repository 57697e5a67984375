"""Multi-pod dry-run: run every (arch x shape) cell's step once on the
production meshes, on fake tensors, and account for it per rank
(counterpart of `repro/launch/dryrun.py`).

The process joins a fake process group of world 256 (16x16) or 512
(2x16x16) — torch's `fake` backend, which answers every collective
without moving data — as the reference's dry-run runs on placeholder host
devices.  The step runs under `FakeTensorMode` (no memory, no compute) and
`StepCounter`, which gives one rank's collective bytes, flops, bytes
accessed and peak live bytes (`launch/step_analysis.py`); the roofline
terms use the H100's peaks.  The mesh's device type is `cuda` where torch
sees a card, else `cpu` (whose all-to-all DTensor runs as an all-gather;
the result says which).  The fake group is process-wide: `--mesh both`
runs the 16x16 cells, destroys the group and joins one of 512.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --json out.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-mlperf --world 4 --smoke
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch  # repro: noqa RPR001 -- dry-run entry point; traces need torch up front
import torch.distributed as dist  # repro: noqa RPR001 -- dry-run entry point

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.step_analysis import StepCounter, analyze_counter, remat_duplication
from repro_torch.launch.steps import SMOKE_DIMS, build_cell, step_cell
from repro_torch.models import transformer as tfm


def init_fake_world(world: int) -> None:
    """Join a fake process group of `world` ranks as rank 0 (the `fake`
    backend registers when its module is imported)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def run_cell(arch_id: str, shape_name: str, mesh, *, smoke: bool = False,
             remat: bool = False, verbose: bool = True) -> dict:
    """Build the cell on `mesh`, run its step once on fake tensors under a
    `StepCounter`, and return the reference's result keys.  `remat`: for
    an LM train cell, run the step again without the per-layer recompute
    and report the flops it adds (`remat_duplication`)."""
    spec = get_arch(arch_id)
    t0 = time.time()
    cell = build_cell(arch_id, shape_name, mesh,
                      cfg_override=spec.smoke_config() if smoke else None,
                      dims_override=SMOKE_DIMS[spec.family] if smoke else None)
    base = {"arch": arch_id, "shape": shape_name, "mesh": _mesh_name(mesh),
            "device_type": mesh.device_type}
    if cell.skip:
        return base | {"status": "skip", "reason": cell.skip}
    t_build = time.time() - t0
    counter = StepCounter()
    t0 = time.time()
    step_cell(cell, mesh, mode=counter)
    t_step = time.time() - t0
    n_dev = mesh.size()
    terms = analyze_counter(counter, n_dev, cell.model_flops)
    coll = counter.collective_bytes()
    notes = cell.notes
    extra = {}
    if remat and spec.family == "lm" and cell.kind == "train":
        plain = StepCounter()
        tfm.set_remat(False)
        try:
            step_cell(cell, mesh, mode=plain)
        finally:
            tfm.set_remat(True)
        extra["remat_duplication"] = remat_duplication(counter.flops, plain.flops)
    if mesh.device_type == "cpu" and coll["all_to_all"] == 0:
        notes = (notes + "; " if notes else "") + \
            "cpu mesh: DTensor's all-to-alls run as all-gathers, counted as such"
    out = base | {
        "status": "ok",
        "kind": cell.kind,
        "build_s": round(t_build, 1),
        "step_s": round(t_step, 1),
        "bytes_per_device": {
            "args": int(counter.arg_bytes),
            "peak": int(counter.peak),
            "temp": int(counter.peak - counter.arg_bytes),
        },
        "collectives": {k: int(v) for k, v in coll.items()},
        "roofline": terms.as_dict(),
        "notes": notes,
    } | extra
    if verbose:
        gb = out["bytes_per_device"]
        print(
            f"[{out['mesh']} {mesh.device_type}] {arch_id} x {shape_name} ({cell.kind}): "
            f"step {t_step:.1f}s  peak/dev {gb['peak'] / 1e9:.3f} GB  "
            f"coll {coll['total'] / 1e6:.1f} MB in {coll['count']}  "
            f"flops/dev {terms.flops:.4g}  bottleneck={terms.bottleneck}",
            flush=True,
        )
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None, help="append results to this JSON-lines file")
    ap.add_argument("--world", type=int, default=None,
                    help="a (2, world/2) host mesh of this many fake ranks instead of the "
                         "production mesh")
    ap.add_argument("--remat", action="store_true",
                    help="LM train cells: also count the flops the per-layer recompute adds")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at small dims (launch/steps.SMOKE_DIMS)")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for aid, spec in ARCHS.items():
            for sname in spec.shapes:
                cells.append((aid, sname))
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        spec = get_arch(args.arch)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        cells = [(args.arch, s) for s in shapes]

    device = "cuda" if torch.cuda.is_available() else "cpu"
    if args.world is not None:
        worlds = [(args.world, lambda: make_host_mesh(2, args.world // 2, device=device))]
    else:
        multis = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
        worlds = [(512 if m else 256,
                   lambda m=m: make_production_mesh(multi_pod=m, device=device)) for m in multis]

    results, failures = [], 0
    for world, make_mesh in worlds:   # one fake group at a time
        init_fake_world(world)
        mesh = make_mesh()
        for arch_id, shape_name in cells:
            try:
                res = run_cell(arch_id, shape_name, mesh, smoke=args.smoke,
                               remat=args.remat)
            except Exception as e:  # a failure here is a bug in the sharding
                failures += 1
                res = {
                    "arch": arch_id, "shape": shape_name, "mesh": _mesh_name(mesh),
                    "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                }
                print(f"FAIL {arch_id} x {shape_name}: {e}", flush=True)
                traceback.print_exc()
            results.append(res)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(res) + "\n")
        dist.destroy_process_group()
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    print(f"\ndry-run summary: {ok} ok, {skip} skip, {failures} FAIL", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
