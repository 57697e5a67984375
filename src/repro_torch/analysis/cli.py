"""Command-line front end for the port's invariant linter (counterpart of
`repro/analysis/cli.py`).

Exit codes: 0 — clean (no new violations), 1 — new violations (or stale
baseline entries under --strict-baseline), 2 — usage / analysis error.
Shared by ``python -m repro_torch.analysis`` and the ``python -m
repro_torch analyze`` verb.  The default target is the port's package and
the default baseline ``ANALYSIS_BASELINE_TORCH.txt`` at the repo root,
which holds no entry: the port carries no legacy debt.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import (
    AnalysisError,
    analyze_paths,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import RULES

#: package root (src/repro_torch) — the default scan target
_PKG_ROOT = Path(__file__).resolve().parent.parent
#: repo root, where the checked-in baseline lives
_REPO_ROOT = _PKG_ROOT.parent.parent
DEFAULT_BASELINE = _REPO_ROOT / "ANALYSIS_BASELINE_TORCH.txt"


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to scan (default: the repro_torch package)",
    )
    parser.add_argument(
        "--select", action="append", default=None, metavar="RPRxxx",
        help="run only these rule ids (repeatable / comma-separated)",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help=f"baseline file (default: {DEFAULT_BASELINE.name} at the repo "
             "root; 'none' disables)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="accept all current violations into the baseline file and exit 0",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (json is the CI gate contract)",
    )
    parser.add_argument(
        "--strict-baseline", action="store_true",
        help="also fail (exit 1) on stale baseline entries",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule registry and exit",
    )


def _resolve_baseline_path(args) -> "Path | None":
    if args.baseline is None:
        return DEFAULT_BASELINE
    if args.baseline.lower() == "none":
        return None
    return Path(args.baseline)


def _parse_select(values) -> "set[str] | None":
    if not values:
        return None
    out: set[str] = set()
    for v in values:
        out.update(s.strip() for s in v.split(",") if s.strip())
    return out or None


def _print_text(report, baseline_path, *, strict: bool, out) -> None:
    for v in report.new:
        print(f"{v.location}:{v.col + 1}: {v.rule} {v.message}", file=out)
        print(f"    {v.line_text.strip()}", file=out)
    if report.stale_baseline:
        print(file=out)
        for entry in report.stale_baseline:
            print(
                f"stale baseline entry {entry['fingerprint']} "
                f"({entry['rule']} at {entry['location']}): violation no "
                f"longer fires — remove it from {baseline_path}",
                file=out,
            )
    print(
        f"\n{len(report.new)} new, {len(report.baselined)} baselined, "
        f"{report.suppressed} noqa-suppressed, "
        f"{len(report.stale_baseline)} stale baseline "
        f"({report.files} files, {report.elapsed_s * 1e3:.0f} ms)",
        file=out,
    )
    if report.new:
        print(
            "new violations: fix them, add '# repro: noqa RPRxxx -- reason' "
            "at the point of use, or (legacy debt only) re-run with "
            "--write-baseline and justify each entry.",
            file=out,
        )
    elif strict and report.stale_baseline:
        print("baseline is stale (--strict-baseline).", file=out)
    else:
        print("ok.", file=out)


def run(args: argparse.Namespace, out=None) -> int:
    out = out if out is not None else sys.stdout
    if args.list_rules:
        for r in RULES:
            print(f"{r.id}  {r.title}", file=out)
        return 0
    paths = args.paths or [str(_PKG_ROOT)]
    baseline_path = _resolve_baseline_path(args)
    try:
        baseline = load_baseline(baseline_path) if baseline_path else {}
        report = analyze_paths(
            paths, select=_parse_select(args.select), baseline=baseline
        )
        if args.write_baseline:
            if baseline_path is None:
                raise AnalysisError("--write-baseline with --baseline none")
            write_baseline(
                report.new + report.baselined, baseline_path, existing=baseline
            )
            print(
                f"wrote {len(report.new) + len(report.baselined)} entries to "
                f"{baseline_path}",
                file=out,
            )
            return 0
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        json.dump(report.to_dict(), out, indent=2, sort_keys=True)
        print(file=out)
    else:
        _print_text(report, baseline_path, strict=args.strict_baseline, out=out)
    failed = bool(report.new) or (args.strict_baseline and report.stale_baseline)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch invariant linter (determinism / concurrency / IO "
        "contracts; see docs/INVARIANTS.md)",
    )
    add_arguments(parser)
    return run(parser.parse_args(argv))


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
