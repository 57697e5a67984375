"""Analyzer engine: file walking, suppression, baseline, report assembly
(counterpart of `repro/analysis/engine.py`).

The engine is rule-agnostic.  It turns every ``*.py`` file under the
scanned roots into a `ModuleInfo` (source + ast with parent links + parsed
``# repro: noqa`` directives), runs each registered rule over each module
it applies to, and folds the raw findings through the two suppression
tiers (line noqa, then the content-fingerprint baseline) into an
`AnalysisReport`.

Fingerprints are content-based, not line-number-based: a baseline entry is
``sha256(rule | relpath | stripped source line | occurrence-index)`` so
adding code above an accepted violation does not invalidate the baseline,
while editing the offending line itself does (the edit must re-justify).

The ``# repro: noqa`` directive, the fingerprint and the baseline grammar
are the reference's, byte for byte: a fixture or a baseline entry means
the same thing to both linters, so their reports compare directly.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
import time
from pathlib import Path

#: ``# repro: noqa`` / ``# repro: noqa RPR001`` / ``# repro: noqa RPR001, RPR002``
#: (an optional ``-- reason`` tail is encouraged and ignored by the parser)
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?![\w-])[:\s]*"
    r"(?P<codes>[A-Z]{3}\d{3}(?:[,\s]+[A-Z]{3}\d{3})*)?"
)

_BASELINE_LINE_RE = re.compile(
    r"^(?P<fp>[0-9a-f]{12})\s+(?P<rule>[A-Z]{3}\d{3})\s+(?P<loc>\S+)"
    r"(?:\s+--\s+(?P<comment>.*))?$"
)


class AnalysisError(Exception):
    """A scanned file could not be analyzed (unreadable / syntax error)."""


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule finding, addressable by content fingerprint."""

    rule: str
    relpath: str
    line: int
    col: int
    message: str
    line_text: str
    fingerprint: str

    @property
    def location(self) -> str:
        return f"{self.relpath}:{self.line}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.relpath,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


class ModuleInfo:
    """A parsed module plus the per-line suppression directives.

    ``tree`` nodes carry a ``parent`` attribute (set here, once) so rules
    can look outward — enclosing function, enclosing class, call context —
    without re-walking.
    """

    def __init__(self, path: Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self._lines_keepends = source.splitlines(keepends=True)
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:
            raise AnalysisError(f"{relpath}: syntax error: {e}") from e
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        # line -> None (all rules) | frozenset of rule ids
        self.noqa: dict[int, "frozenset[str] | None"] = {}
        for i, text in enumerate(self.lines, start=1):
            if "repro" not in text or "noqa" not in text:
                continue
            m = _NOQA_RE.search(text)
            if m is None:
                continue
            codes = m.group("codes")
            if codes:
                self.noqa[i] = frozenset(re.split(r"[,\s]+", codes.strip()))
            else:
                self.noqa[i] = None

    # ------------------------------------------------------------ helpers
    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        if lineno not in self.noqa:
            return False
        codes = self.noqa[lineno]
        return codes is None or rule_id in codes

    def enclosing(self, node: ast.AST, *kinds) -> "ast.AST | None":
        """Nearest ancestor of one of `kinds` (or None)."""
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = getattr(cur, "parent", None)
        return None

    def expr_text(self, node: ast.AST) -> str:
        """Source text of an expression (for pattern heuristics).

        Hand-rolled rather than `ast.get_source_segment`, which re-splits
        the whole source per call (quadratic over a tree walk).
        """
        lineno = getattr(node, "lineno", None)
        end_lineno = getattr(node, "end_lineno", None)
        if lineno is None or end_lineno is None:
            return ""
        lines = self._lines_keepends
        if not (1 <= lineno <= end_lineno <= len(lines)):
            return ""
        col, end_col = node.col_offset, node.end_col_offset
        if lineno == end_lineno:
            return lines[lineno - 1][col:end_col]
        first = lines[lineno - 1][col:]
        middle = lines[lineno:end_lineno - 1]
        last = lines[end_lineno - 1][:end_col]
        return "".join([first, *middle, last])


def _normalize_relpath(rel: Path) -> str:
    parts = list(rel.parts)
    # scanning the repo root or src/ should address modules the same way
    # as scanning src/repro_torch directly: rules match package-relative paths
    if parts[:2] == ["src", "repro_torch"]:
        parts = parts[2:]
    elif parts[:1] == ["repro_torch"]:
        parts = parts[1:]
    return "/".join(parts)


def collect_modules(paths) -> list[ModuleInfo]:
    """Parse every ``*.py`` under `paths` (files or directories)."""
    out: list[ModuleInfo] = []
    for p in paths:
        root = Path(p)
        if not root.exists():
            raise AnalysisError(f"no such path: {root}")
        if root.is_file():
            files = [(root.parent, root)]
        else:
            files = [(root, f) for f in sorted(root.rglob("*.py"))]
        for base, f in files:
            relpath = _normalize_relpath(f.relative_to(base))
            out.append(ModuleInfo(f, relpath, f.read_text(encoding="utf-8")))
    return out


def _fingerprint(rule_id: str, relpath: str, line_text: str, occurrence: int) -> str:
    key = f"{rule_id}|{relpath}|{line_text.strip()}|{occurrence}"
    return hashlib.sha256(key.encode("utf-8")).hexdigest()[:12]


# ------------------------------------------------------------------ baseline


def load_baseline(path) -> dict[str, dict]:
    """fingerprint -> {"rule", "location", "comment"} from a baseline file.

    Missing file == empty baseline.  Malformed non-comment lines are loud:
    a typo'd fingerprint silently accepting nothing is how baselines rot.
    """
    p = Path(path)
    if not p.exists():
        return {}
    entries: dict[str, dict] = {}
    for i, raw in enumerate(p.read_text(encoding="utf-8").splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _BASELINE_LINE_RE.match(line)
        if m is None:
            raise AnalysisError(
                f"{p}:{i}: malformed baseline entry {line!r} (grammar: "
                f"'<fp12> <RULE> <path>:<line> -- <justification>')"
            )
        entries[m.group("fp")] = {
            "rule": m.group("rule"),
            "location": m.group("loc"),
            "comment": m.group("comment") or "",
        }
    return entries


def write_baseline(violations, path, existing: "dict[str, dict] | None" = None) -> None:
    """Write every current violation as an accepted baseline entry.

    Justification comments of entries that are still live are preserved;
    new entries get a TODO marker so un-justified acceptances are greppable.
    """
    existing = existing or {}
    lines = [
        "# repro_torch.analysis baseline — accepted pre-existing violations.",
        "# Grammar: <fingerprint> <RULE> <path>:<line> -- <justification>",
        "# Fingerprints are content-based (see repro_torch/analysis/engine.py);",
        "# regenerate with `python -m repro_torch.analysis --write-baseline`.",
        "",
    ]
    for v in sorted(violations, key=lambda v: (v.relpath, v.line, v.rule)):
        comment = existing.get(v.fingerprint, {}).get("comment") or "TODO: justify"
        lines.append(f"{v.fingerprint} {v.rule} {v.location} -- {comment}")
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


# -------------------------------------------------------------------- report


@dataclasses.dataclass
class AnalysisReport:
    """Outcome of one analyzer run over a set of roots."""

    new: list[Violation]
    baselined: list[Violation]
    suppressed: int
    stale_baseline: list[dict]
    files: int
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return not self.new

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "files": self.files,
            "elapsed_s": round(self.elapsed_s, 6),
            "counts": {
                "new": len(self.new),
                "baselined": len(self.baselined),
                "suppressed": self.suppressed,
                "stale_baseline": len(self.stale_baseline),
            },
            "violations": [v.to_dict() for v in self.new],
            "baselined": [v.to_dict() for v in self.baselined],
            "stale_baseline": self.stale_baseline,
        }


def analyze_paths(
    paths,
    *,
    select: "set[str] | None" = None,
    baseline: "dict[str, dict] | None" = None,
    rules=None,
) -> AnalysisReport:
    """Run `rules` (default: the full registry) over `paths`.

    `select` narrows to specific rule ids; `baseline` is the mapping from
    `load_baseline`.  Returns an `AnalysisReport`; raises `AnalysisError`
    on unreadable/unparseable inputs or an unknown selected rule.
    """
    from repro_torch.analysis.rules import RULES

    t0 = time.perf_counter()
    active = list(rules if rules is not None else RULES)
    if select:
        known = {r.id for r in active}
        unknown = set(select) - known
        if unknown:
            raise AnalysisError(
                f"unknown rule id(s): {', '.join(sorted(unknown))} "
                f"(known: {', '.join(sorted(known))})"
            )
        active = [r for r in active if r.id in select]
    modules = collect_modules(paths)
    raw: list[tuple[ModuleInfo, str, int, int, str]] = []
    for mi in modules:
        for rule in active:
            if not rule.applies(mi):
                continue
            for line, col, message in rule.check(mi):
                raw.append((mi, rule.id, line, col, message))

    suppressed = 0
    kept: list[Violation] = []
    occ_counter: dict[tuple[str, str, str], int] = {}
    # fingerprint occurrence indices must be assigned in file order
    raw.sort(key=lambda t: (t[0].relpath, t[2], t[3], t[1]))
    for mi, rule_id, line, col, message in raw:
        if mi.suppressed(rule_id, line):
            suppressed += 1
            continue
        text = mi.line_text(line)
        key = (rule_id, mi.relpath, text.strip())
        occ = occ_counter.get(key, 0)
        occ_counter[key] = occ + 1
        kept.append(
            Violation(
                rule=rule_id,
                relpath=mi.relpath,
                line=line,
                col=col,
                message=message,
                line_text=text,
                fingerprint=_fingerprint(rule_id, mi.relpath, text, occ),
            )
        )

    baseline = baseline or {}
    new = [v for v in kept if v.fingerprint not in baseline]
    old = [v for v in kept if v.fingerprint in baseline]
    live = {v.fingerprint for v in old}
    stale = [
        {"fingerprint": fp, **meta}
        for fp, meta in baseline.items()
        if fp not in live
    ]
    return AnalysisReport(
        new=new,
        baselined=old,
        suppressed=suppressed,
        stale_baseline=stale,
        files=len(modules),
        elapsed_s=time.perf_counter() - t0,
    )
