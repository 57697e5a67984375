"""repro_torch.analysis — the invariant linter, applied to the port
(counterpart of `repro.analysis`, DESIGN.md §15).

BuffCut's headline guarantee is *bit-determinism*: the same stream twice
yields bit-identical labels across drivers, shards, checkpoints and the
serve subsystem.  The conventions that guarantee depends on — pinned f64
summation order, join-on-every-exit-path thread lifecycle, lazy
accelerator imports, tmp+fsync+`os.replace` durable writes, the
`IncrementalCut` stage/commit bracket — are machine-checked here: the
linter walks the source tree with `ast` and applies the reference's eight
rules (`repro_torch.analysis.rules`), each named after the incident that
motivated it.  Two of them are read for torch: RPR001's heavy import is
`torch`, and RPR004 also flags draws from torch's default generator.

Entry points::

    python -m repro_torch.analysis                 # text report, exit 1 on new findings
    python -m repro_torch.analysis --format json   # machine-readable report (CI gate)
    python -m repro_torch analyze                  # the same checker as a CLI verb

Suppression is two-tier, with the reference's grammar:

* per-line ``# repro: noqa RPR001`` (or bare ``# repro: noqa``) accepts a
  specific occurrence forever, with its reason after ``--``;
* the checked-in baseline (``ANALYSIS_BASELINE_TORCH.txt``) accepts
  pre-existing violations by content fingerprint.  The port's is empty:
  every finding is fixed or justified at the point of use.

The package is stdlib-only (ast + argparse): importing it never pays numpy
or torch, so the gate runs in milliseconds.
"""
from repro_torch.analysis.engine import (
    AnalysisError,
    AnalysisReport,
    ModuleInfo,
    Violation,
    analyze_paths,
    collect_modules,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import RULES, Rule, get_rule
from repro_torch.analysis.cli import main

__all__ = [
    "AnalysisError",
    "AnalysisReport",
    "ModuleInfo",
    "Violation",
    "analyze_paths",
    "collect_modules",
    "load_baseline",
    "write_baseline",
    "RULES",
    "Rule",
    "get_rule",
    "main",
]
