"""``python -m repro_torch``: the command-line twin of `repro_torch.api`.

    python -m repro_torch partition graph.bcsr -k 16 --driver pipelined \
        --engine torch --ordering bfs --json out.json
    python -m repro_torch partition gen:grid:side=64 -k 8 --device cpu
    python -m repro_torch serve gen:grid:side=64 -k 8 --device cpu
    python -m repro_torch gen grid -o mesh.bcsr --param side=64
    python -m repro_torch list -v
    python -m repro_torch analyze --format json

`partition` resolves any source the API accepts (METIS text, packed binary,
``gen:`` spec), runs the chosen registry driver, prints a one-line quality
summary and optionally writes the full `PartitionResult` JSON.  `partition`
and `serve` run the V-cycle on the card unless ``--device cpu`` is given;
with no card they fail rather than run on the host.  `serve` keeps the
partition resident and replays a churn workload through it.  `gen`
synthesizes an instance family to disk (packed by default, METIS text with
``--format metis``), files byte-identical to the reference's.  `list`
prints the registry.  `analyze` runs the invariant linter
(`repro_torch.analysis`) over the port.  Importing this module, and the
`list`, `gen` and `analyze` verbs, load no torch.
"""
from __future__ import annotations

import argparse
import sys


def _add_partition_parser(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "partition",
        help="partition a graph source through the unified API",
        description="Partition SOURCE (CSR file path or gen:<family>:... spec) "
                    "with any registered driver.",
    )
    p.add_argument("source", nargs="?", default=None,
                   help="METIS text / packed binary path, or gen:<family>:k=v,... spec "
                        "(optional with --resume when the checkpoint recorded it)")
    p.add_argument("-k", type=int, default=None, help="number of blocks")
    p.add_argument("--driver", default="buffcut",
                   help="registry name or alias (see `python -m repro_torch list`)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "sparse", "ell", "torch"],
                   help="multilevel engine")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the multilevel engine runs (no host fallback)")
    p.add_argument("--ordering", default="natural",
                   choices=["natural", "random", "bfs", "konect"],
                   help="stream ordering (realized on disk for disk sources)")
    p.add_argument("--order-seed", type=int, default=0)
    p.add_argument("--score", default="haa", help="buffer score (anr/cbs/haa/nss/cms)")
    p.add_argument("--eps", type=float, default=0.03, help="balance slack")
    p.add_argument("--buffer-size", type=int, default=None, help="Q_max (default: n/8)")
    p.add_argument("--batch-size", type=int, default=None, help="delta (default: n/32)")
    p.add_argument("--d-max", type=float, default=None, help="hub threshold (default: n/16)")
    p.add_argument("--gamma", type=float, default=1.5)
    p.add_argument("--wave", type=int, default=1, help="vectorized: eviction wave size")
    p.add_argument("--chunk", type=int, default=1, help="vectorized: arrival chunk size")
    p.add_argument("--queue-depth", type=int, default=4, help="pipelined: task queue bound")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="stream prefetcher depth in batches (0 disables the "
                        "background reader thread)")
    p.add_argument("--workers", type=int, default=1, metavar="W",
                   help="shard the stream across W BuffCut workers "
                        "(contiguous id ranges; pair with --restream to "
                        "reconcile the shard seams)")
    p.add_argument("--load-sync-every", type=int, default=8, metavar="S",
                   help="sharded: committed batches between load-sync "
                        "barrier rounds per worker")
    p.add_argument("--shard-backend", default="thread",
                   choices=["thread", "process"],
                   help="sharded: worker threads (deterministic anchor) or "
                        "forked processes (multi-core scaling)")
    p.add_argument("--restream", type=int, default=0, metavar="N",
                   help="restreaming refinement passes (replays the stream "
                        "out-of-core on disk sources)")
    p.add_argument("--restream-order", default="stream",
                   choices=["stream", "priority"],
                   help="replay order for restream passes: contiguous stream "
                        "order or gain-prioritized δ-batches")
    p.add_argument("--checkpoint", metavar="PATH", default=None,
                   help="write crash-safe snapshots here (atomic; resume "
                        "with --resume PATH)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="committed batches between snapshots "
                        "(default 8 when --checkpoint is set)")
    p.add_argument("--resume", metavar="CKPT", default=None,
                   help="resume a checkpointed run bit-identically; config "
                        "and source come from the checkpoint (tuning flags "
                        "are ignored), SOURCE overrides the recorded one")
    p.add_argument("--materialize", action="store_true",
                   help="load a disk source into memory (required for "
                        "memory-only drivers on file sources)")
    p.add_argument("--stats", action="store_true",
                   help="collect per-batch stats (IER, evictions)")
    p.add_argument("--json", metavar="PATH", default=None,
                   help="write the full PartitionResult JSON here")
    p.set_defaults(cmd=_cmd_partition)


def _print_summary(res, json_path: "str | None") -> None:
    prov = res.provenance
    print(
        f"driver={prov['driver']} engine={prov['engine']} device={prov['device']} "
        f"ordering={prov['ordering']} "
        f"source={prov['source']['kind']} n={prov['source']['n']} m={prov['source']['m']} "
        f"k={res.k} cut_ratio={res.cut_ratio:.4f} balance={res.balance:.3f} "
        f"runtime_s={prov['runtime_s']:.3f}"
    )
    if json_path:
        res.to_json(json_path)
        print(f"wrote {json_path}")


def _cmd_partition(args: argparse.Namespace) -> int:
    from repro_torch.api import DriverConfig, partition, resolve_source, resume
    from repro_torch.configs.buffcut_paper import scaled_config
    from repro_torch.device import preflight

    if args.resume:
        overrides = {}
        if args.checkpoint:
            overrides["checkpoint_path"] = args.checkpoint
        if args.checkpoint_every:
            overrides["checkpoint_every"] = args.checkpoint_every
        res = resume(args.resume, source=args.source, **overrides)
        _print_summary(res, args.json)
        return 0
    if args.source is None:
        raise ValueError("SOURCE is required unless --resume is given")
    if args.k is None:
        raise ValueError("-k is required unless --resume is given")
    if args.engine != "sparse":
        preflight(args.device)  # refuse a missing card before reading the source
    src = resolve_source(args.source)
    if args.materialize:
        src.materialize()
    n = src.stream.n
    base = scaled_config(n, k=args.k, eps=args.eps)
    dc = DriverConfig.create(
        DriverConfig(buffcut=base),
        driver=args.driver,
        k=args.k,
        eps=args.eps,
        score=args.score,
        gamma=args.gamma,
        engine=args.engine,
        device=args.device,
        ordering=args.ordering,
        order_seed=args.order_seed,
        restream_passes=args.restream,
        restream_order=args.restream_order,
        wave=args.wave,
        chunk=args.chunk,
        queue_depth=args.queue_depth,
        prefetch_batches=args.prefetch_batches,
        workers=args.workers,
        load_sync_every=args.load_sync_every,
        shard_backend=args.shard_backend,
        collect_stats=args.stats,
        **{
            key: val
            for key, val in (
                ("buffer_size", args.buffer_size),
                ("batch_size", args.batch_size),
                ("d_max", args.d_max),
                ("checkpoint_path", args.checkpoint),
                ("checkpoint_every", args.checkpoint_every or None),
            )
            if val is not None
        },
    )
    res = partition(src, dc)
    _print_summary(res, args.json)
    return 0


def _add_serve_parser(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "serve",
        help="partition a source, keep it resident, and drive a scripted "
             "update/lookup/refine workload",
        description="Partition SOURCE, promote the result into a resident "
                    "PartitionService (repro_torch.serve), and replay a scripted "
                    "workload — a delta file (--delta-file) or a generated "
                    "churn spec (--workload gen:churn:updates=64,...) — "
                    "through a ServeSession, reporting per-verb latencies, "
                    "sustained rates, and the exactness check "
                    "(resident cut == edge_cut recompute).",
    )
    p.add_argument("source",
                   help="METIS text / packed binary path, or gen:<family>:... spec")
    p.add_argument("-k", type=int, required=True, help="number of blocks")
    p.add_argument("--driver", default="buffcut",
                   help="dynamic-capable registry driver "
                        "(see `python -m repro_torch list` capability flags)")
    p.add_argument("--workload", default="gen:churn:",
                   help="churn spec: gen:churn:updates=64,ops=16,frac_del=0.25,"
                        "node_adds=0,lookup_every=4,lookup_size=256,"
                        "refine_every=8,seed=0 (defaults shown for omitted "
                        "fields)")
    p.add_argument("--delta-file", metavar="PATH", default=None,
                   help="scripted delta file (overrides --workload; see "
                        "repro_torch.serve.workload for the line grammar)")
    p.add_argument("--eps", type=float, default=0.03, help="balance slack")
    p.add_argument("--score", default="haa", help="buffer score (anr/cbs/haa/nss/cms)")
    p.add_argument("--buffer-size", type=int, default=None, help="Q_max (default: n/8)")
    p.add_argument("--batch-size", type=int, default=None, help="delta (default: n/32)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the V-cycles of the partition and the refines run")
    p.add_argument("--queue-depth", type=int, default=256,
                   help="session request queue bound")
    p.add_argument("--json", metavar="PATH", default=None,
                   help="write the serve report JSON here (default: stdout "
                        "summary only)")
    p.set_defaults(cmd=_cmd_serve)


def _cmd_serve(args: argparse.Namespace) -> int:
    import dataclasses
    import json

    from repro_torch.api import DriverConfig, partition, resolve_source
    from repro_torch.configs.buffcut_paper import scaled_config
    from repro_torch.core.metrics import edge_cut
    from repro_torch.device import preflight
    from repro_torch.serve import ChurnSpec, ServeSession, churn_ops, load_delta_file, run_workload

    preflight(args.device)  # refuse a missing card before reading the source
    src = resolve_source(args.source)
    src.materialize()  # the service keeps the graph resident
    base = scaled_config(src.stream.n, k=args.k, eps=args.eps)
    dc = DriverConfig.create(
        DriverConfig(buffcut=base),
        driver=args.driver, k=args.k, eps=args.eps, score=args.score,
        device=args.device,
        **{key: val for key, val in (("buffer_size", args.buffer_size),
                                     ("batch_size", args.batch_size))
           if val is not None},
    )
    res = partition(src, dc)
    service = res.into_service()
    if args.delta_file is not None:
        ops = load_delta_file(args.delta_file)
        workload_desc = {"kind": "delta_file", "path": args.delta_file}
    else:
        spec = ChurnSpec.parse(args.workload)
        ops = churn_ops(service.export_graph(), spec)
        workload_desc = {"kind": "churn", "spec": dataclasses.asdict(spec)}
    with ServeSession(service, queue_depth=args.queue_depth) as sess:
        summary = run_workload(sess, ops)
    cut_recompute = edge_cut(service.export_graph(), service.labels)
    report = {
        "provenance": {
            "driver": res.provenance["driver"],
            "source": res.provenance["source"],
            "k": res.k,
            "initial_cut": float(res.cut_weight),
            "workload": workload_desc,
            "ops": len(ops),
        },
        "workload": summary,
        "session": dict(sess.stats),
        "service": service.stats(),
        "exact": {
            "resident_cut": float(service.cut_weight),
            "recomputed_cut": float(cut_recompute),
            "match": bool(service.cut_weight == cut_recompute),
        },
    }
    if not report["exact"]["match"]:
        print(
            f"error: resident cut {service.cut_weight} != recomputed "
            f"{cut_recompute} after the workload — exactness invariant "
            "violated",
            file=sys.stderr,
        )
        return 1
    upd = summary["update"]
    lkp = summary["lookup"]
    print(
        f"serve driver={res.provenance['driver']} n={service.n} m={service.m} "
        f"k={service.k} ops={len(ops)} "
        f"cut={service.cut_weight:.0f} (exact) balance={service.balance:.3f} "
        f"updates_per_s={upd['updates_per_s']:.0f} "
        f"lookup_p50_ms={lkp['p50_ms']:.3f} lookup_p99_ms={lkp['p99_ms']:.3f}"
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, sort_keys=True, indent=1)
        print(f"wrote {args.json}")
    return 0


def _add_gen_parser(sub: "argparse._SubParsersAction") -> None:
    p = sub.add_parser(
        "gen",
        help="synthesize an instance family to disk",
        description="Generate FAMILY to -o PATH (packed binary by default; "
                    "grid/ring stream incrementally and never materialize).",
    )
    p.add_argument("family", help="rmat | rgg | rhg | grid | sbm | star | ring")
    p.add_argument("-o", "--out", required=True, help="output path")
    p.add_argument("--format", default="packed", choices=["packed", "metis"],
                   help="on-disk format")
    p.add_argument("--param", action="append", default=[], metavar="K=V",
                   help="generator parameter, repeatable (e.g. --param side=64)")
    p.set_defaults(cmd=_cmd_gen)


def _cmd_gen(args: argparse.Namespace) -> int:
    from repro_torch.graphs.generators import generate_to_disk
    from repro_torch.graphs.io import write_metis
    from repro_torch.api.sources import GEN_PREFIX, GENERATORS, parse_generator_spec

    # one parser for generator params: the same spec syntax partition accepts
    spec = GEN_PREFIX + args.family
    if args.param:
        spec += ":" + ",".join(args.param)
    family, params = parse_generator_spec(spec)
    if args.format == "packed":
        n = generate_to_disk(family, args.out, **params)
    else:
        g = GENERATORS[family](**params)
        write_metis(g, args.out)
        n = g.n
    print(f"wrote {args.out} ({family}, n={n}, format={args.format})")
    return 0


def _cmd_list(args: argparse.Namespace) -> int:
    from repro_torch.api import get_partitioner, list_partitioners

    for name in list_partitioners():
        spec = get_partitioner(name)
        mode = "streaming" if spec.streaming else "memory-only"
        caps = spec.capabilities()
        flags = ", ".join(
            label for label, on in (
                ("disk-stream", caps["disk_stream"]),
                ("checkpoint", caps["checkpoint"]),
                ("shard", caps["shard"]),
                ("dynamic", caps["dynamic"]),
            ) if on
        ) or "none"
        line = f"{name:14s} [{mode}]  caps: {flags}"
        if spec.aliases:
            line += f"  aliases: {', '.join(spec.aliases)}"
        print(line)
        if args.verbose and spec.description:
            print(f"    {spec.description}")
    return 0


def _cmd_analyze(args: argparse.Namespace) -> int:
    # the analyzer is stdlib-only; its exit code is the verb's exit code
    from repro_torch.analysis.cli import run as analysis_run

    return analysis_run(args)


def _add_analyze_parser(sub: "argparse._SubParsersAction") -> None:
    from repro_torch.analysis.cli import add_arguments

    p = sub.add_parser(
        "analyze",
        help="run the repo invariant linter over the port (docs/INVARIANTS.md)",
        description="AST-based invariant linter: determinism, concurrency "
        "and IO contracts (rules RPR001-RPR008, read for torch).",
    )
    add_arguments(p)
    p.set_defaults(cmd=_cmd_analyze)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="BuffCut in PyTorch/CUDA: the unified partitioner front door.",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    _add_partition_parser(sub)
    _add_serve_parser(sub)
    _add_gen_parser(sub)
    _add_analyze_parser(sub)
    p_list = sub.add_parser("list", help="list registered partitioners")
    p_list.add_argument("-v", "--verbose", action="store_true")
    p_list.set_defaults(cmd=_cmd_list)
    return ap


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.cmd(args)
    except (ValueError, TypeError, KeyError, FileNotFoundError, RuntimeError) as e:
        # RuntimeError: a card asked for and missing, or a device fault
        print(f"error: {e}", file=sys.stderr)
        return 1
