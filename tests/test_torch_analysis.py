"""repro_torch.analysis against repro.analysis: every rule's firing and
silent fixtures, the noqa tiers, the baseline, the loud errors and the CLI
contract, each as a counterpart of tests/test_analysis.py.

The two linters share the directive, the fingerprint and the baseline
grammar, so RPR002-RPR008 must give byte-equal reports on every fixture
and on the whole `src/repro` tree.  RPR001 is read for torch: each jax
fixture and its torch rewrite fire at the same positions.  RPR004 also
flags draws from torch's default generator, which the reference has no
counterpart of.  Last, the port passes its own linter under its empty
baseline.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import tokenize
from pathlib import Path

import pytest

import repro.analysis as RA
import repro.analysis.engine as RE
import repro.analysis.rules as RR
from repro_torch.analysis import (
    AnalysisError,
    analyze_paths,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.engine import ModuleInfo
from repro_torch.analysis.rules import RULES, get_rule

REPO_ROOT = Path(__file__).resolve().parent.parent
SRC = REPO_ROOT / "src"
PORT_BASELINE = REPO_ROOT / "ANALYSIS_BASELINE_TORCH.txt"
PARITY_RULES = {f"RPR00{i}" for i in range(2, 9)}
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
#: the two entry points of the port's linter
PORT_CLIS = {
    "module": [sys.executable, "-m", "repro_torch.analysis"],
    "verb": [sys.executable, "-m", "repro_torch", "analyze"],
}


def _check(get, mi_cls, rule_id, source, relpath):
    mi = mi_cls(Path(relpath), relpath, textwrap.dedent(source))
    rule = get(rule_id)
    if not rule.applies(mi):
        return []
    return list(rule.check(mi))


def check(rule_id: str, source: str, relpath: str = "core/mod.py"):
    """Run one of the port's rules over an inline snippet; [] if out of scope."""
    return _check(get_rule, ModuleInfo, rule_id, source, relpath)


def ref_check(rule_id: str, source: str, relpath: str = "core/mod.py"):
    return _check(RR.get_rule, RE.ModuleInfo, rule_id, source, relpath)


def fires(rule_id: str, source: str, relpath: str = "core/mod.py") -> bool:
    return bool(check(rule_id, source, relpath))


# ---------------------------------------------------------------- fixtures
# (rule, source, relpath): tests/test_analysis.py's fixtures, in its order

FIRING = [
    ("RPR002", """
        import threading

        def start():
            t = threading.Thread(target=work)
            t.start()
        """, "core/mod.py"),
    ("RPR002", "import queue\nq = queue.Queue()\n", "core/mod.py"),
    ("RPR002", "from queue import Queue as Q\n\ndef f():\n    return Q()\n", "core/mod.py"),
    ("RPR003", "n_total = float(g.node_w.sum())\n", "core/mod.py"),
    ("RPR003", "x = float(np.sum(w[cross]))\n", "core/mod.py"),
    ("RPR003", "cap = l_max(float(g.node_w.sum()), k, eps)\n", "core/mod.py"),
    ("RPR003", "total_w = sum(ws)\n", "core/mod.py"),
    ("RPR003", "p = P(n_total=sum(float(w) for w in ws))\n", "core/mod.py"),
    ("RPR003", """
        def f(dirty, labels):
            for v in set(dirty):
                labels[v] = 0
        """, "core/mod.py"),
    ("RPR004", "import numpy as np\nx = np.random.rand(3)\n", "core/mod.py"),
    ("RPR004", "import numpy as np\nnp.random.seed(0)\n", "core/mod.py"),
    ("RPR004", "import random\nrandom.shuffle(xs)\n", "core/mod.py"),
    ("RPR004", "from random import shuffle\n", "core/mod.py"),
    ("RPR005", "def save(path, data):\n    with open(path, 'wb') as f:\n        f.write(data)\n",
     "train/checkpoint.py"),
    ("RPR005", """
        import os

        def save(tmp, final, data):
            with open(tmp, 'wb') as f:
                f.write(data)
            os.replace(tmp, final)
        """, "train/checkpoint.py"),
    ("RPR005", "import os\n\ndef f(a, b):\n    os.rename(a, b)\n", "train/checkpoint.py"),
    ("RPR006", "try:\n    work()\nexcept:\n    pass\n", "core/mod.py"),
    ("RPR006", "try:\n    work()\nexcept Exception:\n    pass\n", "core/mod.py"),
    ("RPR006", """
        try:
            work()
        except ValueError:
            raise RuntimeError("wrapped")
        """, "core/mod.py"),
    ("RPR007", """
        def apply(self, moved, old):
            self.cm.stage(moved, old)
            do_partition()
        """, "core/mod.py"),
    ("RPR007", """
        def apply(self, moved, old, new):
            self.cm.stage(moved, old)
            other.commit(moved, new)
        """, "core/mod.py"),
    ("RPR008", "def read(path):\n    with open(path, 'rb') as f:\n        return f.read()\n",
     "graphs/newreader.py"),
    ("RPR008", "def opener(path, mode):\n    return open(path, mode)\n", "graphs/newreader.py"),
]

SILENT = [
    ("RPR002", """
        import threading

        def run():
            t = threading.Thread(target=work)
            t.start()
            try:
                consume()
            finally:
                t.join()
        """, "core/mod.py"),
    ("RPR002", """
        import threading

        class Worker:
            def __init__(self):
                self._thread = threading.Thread(target=self._run, daemon=True)
                self._thread.start()

            def close(self):
                self._thread.join(timeout=5.0)
        """, "core/mod.py"),
    ("RPR002", """
        import threading

        class Pool:
            def start(self):
                for i in range(4):
                    t = threading.Thread(target=work)
                    self._threads.append(t)
                    t.start()

            def _join_all(self):
                for t in self._threads:
                    t.join()
        """, "core/mod.py"),
    ("RPR002", """
        import threading
        import queue

        class Pump:
            def _start(self):
                q = queue.Queue(maxsize=4)
                t = threading.Thread(target=pump, daemon=True)
                self._q, self._thread = q, t
                t.start()

            def _shutdown(self):
                t, q = self._thread, self._q
                t.join(timeout=5.0)
        """, "core/mod.py"),
    ("RPR002", "import queue\nq = queue.Queue(maxsize=8)\n", "core/mod.py"),
    ("RPR003", "n_total = float(np.sum(node_w.astype(np.float64)))\n", "core/mod.py"),
    ("RPR003", "m = float(g.edge_w.astype(np.float64).sum() / 2.0)\n", "core/mod.py"),
    ("RPR003", "n_bytes = sum(a.nbytes for a in arrays)\n", "core/mod.py"),
    ("RPR003", """
        def f(dirty, labels):
            for v in sorted(set(dirty)):
                labels[v] = 0
        """, "core/mod.py"),
    ("RPR003", """
        def f(dirty, labels):
            acc = []
            for v in set(dirty):
                acc.append(labels[v])
        """, "core/mod.py"),
    ("RPR003", "x = float(a.sum())\n", "launch/roofline.py"),
    ("RPR004", "import numpy as np\nrng = np.random.default_rng(17)\nx = rng.random(3)\n",
     "core/mod.py"),
    ("RPR004", "import numpy as np\n\ndef f(rng: np.random.Generator):\n    return rng\n",
     "core/mod.py"),
    ("RPR004", "import numpy as np\nx = np.random.rand(3)\n", "tests/test_mod.py"),
    ("RPR004", "random = make_thing()\ny = random.choice\n", "core/mod.py"),
    ("RPR005", """
        import os

        def save(path, data):
            tmp = f"{path}.tmp"
            with open(tmp, 'wb') as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        """, "train/checkpoint.py"),
    ("RPR005", "def dump(path, s):\n    with open(path, 'w') as f:\n        f.write(s)\n",
     "launch/report.py"),
    ("RPR006", "try:\n    work()\nexcept OSError:\n    pass\n", "core/mod.py"),
    ("RPR006", "try:\n    work()\nexcept Exception as e:\n    log(e)\n", "core/mod.py"),
    ("RPR006", """
        try:
            work()
        except ValueError as e:
            raise RuntimeError("wrapped") from e
        """, "core/mod.py"),
    ("RPR006", """
        try:
            work()
        except ValueError:
            raise RuntimeError("severed") from None
        """, "core/mod.py"),
    ("RPR006", "try:\n    work()\nexcept ValueError as e:\n    raise\n", "core/mod.py"),
    ("RPR007", """
        def apply(self, moved, old, new):
            self.cm.stage(moved, old)
            labels = do_partition()
            self.cm.commit(moved, new)
            return labels
        """, "core/mod.py"),
    ("RPR008", """
        def read(path, retry):
            with _retrying(lambda: open(path, 'rb'), retry) as f:
                return f.read()
        """, "graphs/newreader.py"),
    ("RPR008", "def read(path):\n    return open(path, 'rb').read()\n", "core/config.py"),
]

# RPR001: the reference's jax fixture beside its torch rewrite
RPR001_FIRING = [
    ("import jax\n", "import torch\n"),
    ("import jax.numpy as jnp\n", "import torch.nn.functional as F\n"),
    ("from jax.sharding import Mesh\n", "from torch.distributed.tensor import DTensor\n"),
    ("""
     try:
         import jax
     except ImportError:
         jax = None
     """, """
     try:
         import torch
     except ImportError:
         torch = None
     """),
]
RPR001_SILENT = [
    ("""
     def kernel():
         import jax
         return jax
     """, """
     def kernel():
         import torch
         return torch
     """, "core/mod.py"),
    ("""
     from typing import TYPE_CHECKING
     if TYPE_CHECKING:
         import jax
     """, """
     from typing import TYPE_CHECKING
     if TYPE_CHECKING:
         import torch
     """, "core/mod.py"),
    ("import numpy as np\n", "import numpy as np\n", "core/mod.py"),
    ("import jax\n", "import torch\n", "kernels/ops.py"),
    ("import jax\n", "import torch\n", "train/steps.py"),
]

# RPR004's port reading: draws from torch's process-global generator
RPR004_TORCH_FIRING = [
    "import torch\ntorch.manual_seed(0)\n",
    "import torch\ntorch.seed()\n",
    "import torch\ntorch.cuda.manual_seed(0)\n",
    "import torch\ntorch.cuda.manual_seed_all(0)\n",
    "import torch\nx = torch.rand(3)\n",
    "import torch\nx = torch.randn(3, 4, device='cuda')\n",
    "import torch\nx = torch.randint(0, 9, (3,))\n",
    "from torch import randperm\np = randperm(8)\n",
    "import torch\nx = torch.normal(0.0, 1.0, (3,))\n",
    "import torch\nx = torch.bernoulli(p)\n",
    "import torch as T\nx = T.multinomial(p, 2)\n",
    "import torch\nx = torch.rand(3, generator=None)\n",
    "import torch\nx = torch.empty(3).uniform_(0, 1)\n",
    "def f(w):\n    w.normal_()\n",
    "def f(w):\n    w.bernoulli_(0.5)\n",
    "def f(w):\n    w.random_(0, 9)\n",
    "def f(w):\n    w.exponential_()\n",
    "import torch.nn as nn\nnn.init.normal_(w)\n",
]
RPR004_TORCH_SILENT = [
    ("import torch\ng = torch.Generator().manual_seed(0)\nx = torch.randn(3, generator=g)\n",
     "core/mod.py"),
    ("import torch\ng = torch.Generator(device='cuda')\ng.manual_seed(7)\n", "core/mod.py"),
    ("import torch\nx = torch.randint(0, 9, (3,), generator=gen)\n", "core/mod.py"),
    ("def f(w, gen):\n    w.uniform_(-1, 1, generator=gen)\n", "core/mod.py"),
    ("import torch\nx = torch.zeros(3).normal\n", "core/mod.py"),
    ("import torch\nx = torch.arange(8)\n", "core/mod.py"),
    ("import torch\ntorch.manual_seed(0)\n", "tests/test_mod.py"),
    ("import torch\nx = torch.rand(3)\n", "examples/demo.py"),
]


def _ids(cases):
    return [f"{c[0]}-{i}" for i, c in enumerate(cases)]


# ---------------------------------------------------------------- registry


def test_registry_ids_unique_and_documented():
    ids = [r.id for r in RULES]
    assert len(ids) == len(set(ids))
    assert ids == [r.id for r in RR.RULES]
    for r, ref in zip(RULES, RR.RULES):
        assert r.id.startswith("RPR") and len(r.id) == 6
        assert r.title and r.title == ref.title
        assert (r.modules, r.exempt) == (ref.modules, ref.exempt), r.id
        # every docstring must carry the contract and a motivating incident
        assert r.__doc__ and "Incident" in r.__doc__, r.id
    for r in (get_rule("RPR001"), get_rule("RPR004")):
        assert "Port reading" in r.__doc__, r.id
    assert get_rule("RPR001").HEAVY == ("torch",)

    with pytest.raises(KeyError):
        get_rule("RPR999")


# ------------------------------------------------------------------ RPR001


@pytest.mark.parametrize("jax_src,torch_src", RPR001_FIRING,
                         ids=[f"fire-{i}" for i in range(len(RPR001_FIRING))])
def test_rpr001_fires_on_eager_torch_import(jax_src, torch_src):
    ref = ref_check("RPR001", jax_src)
    port = check("RPR001", torch_src)
    assert port and [(ln, col) for ln, col, _ in port] == [(ln, col) for ln, col, _ in ref]
    assert all("torch" in msg for _, _, msg in port)
    # each linter reads only its own stack
    assert check("RPR001", jax_src) == [] and ref_check("RPR001", torch_src) == []


@pytest.mark.parametrize("jax_src,torch_src,relpath", RPR001_SILENT,
                         ids=[f"silent-{i}" for i in range(len(RPR001_SILENT))])
def test_rpr001_silent_on_compliant(jax_src, torch_src, relpath):
    assert ref_check("RPR001", jax_src, relpath) == []
    assert not fires("RPR001", torch_src, relpath)


# ----------------------------------------------------------- RPR002-RPR008


@pytest.mark.parametrize("rule_id,src,relpath", FIRING, ids=_ids(FIRING))
def test_rule_fires_on_incident_pattern(rule_id, src, relpath):
    assert fires(rule_id, src, relpath)


@pytest.mark.parametrize("rule_id,src,relpath", SILENT, ids=_ids(SILENT))
def test_rule_silent_on_compliant_idiom(rule_id, src, relpath):
    assert not fires(rule_id, src, relpath)


def test_rpr002_unjoined_thread_is_one_finding():
    assert len(check("RPR002", FIRING[0][1])) == 1


@pytest.mark.parametrize("rule_id,src,relpath", FIRING + SILENT,
                         ids=_ids(FIRING) + [f"silent-{c}" for c in _ids(SILENT)])
def test_findings_equal_the_reference(rule_id, src, relpath):
    assert check(rule_id, src, relpath) == ref_check(rule_id, src, relpath)


# ------------------------------------------------------ RPR004, port reading


@pytest.mark.parametrize("src", RPR004_TORCH_FIRING,
                         ids=[f"fire-{i}" for i in range(len(RPR004_TORCH_FIRING))])
def test_rpr004_fires_on_torch_default_generator(src):
    out = check("RPR004", src)
    assert len(out) == 1 and "generator" in out[0][2]
    # the reference has no global generator to guard
    assert ref_check("RPR004", src) == []


@pytest.mark.parametrize("src,relpath", RPR004_TORCH_SILENT,
                         ids=[f"silent-{i}" for i in range(len(RPR004_TORCH_SILENT))])
def test_rpr004_silent_with_explicit_generator(src, relpath):
    assert not fires("RPR004", src, relpath)


# -------------------------------------------------------------- suppression


def _write_mod(root: Path, text: str, rel: str = "core/mod.py") -> Path:
    mod = root / rel
    mod.parent.mkdir(parents=True, exist_ok=True)
    mod.write_text(text)
    return mod


def test_noqa_suppresses_specific_rule_only(tmp_path):
    _write_mod(tmp_path, "import torch  # repro: noqa RPR001 -- fixture\n"
                         "import queue\n"
                         "q = queue.Queue()\n")
    report = analyze_paths([tmp_path])
    assert report.suppressed == 1
    assert [v.rule for v in report.new] == ["RPR002"]


def test_bare_noqa_suppresses_all_rules(tmp_path):
    _write_mod(tmp_path, "n_total = float(w.sum())  # repro: noqa\n")
    report = analyze_paths([tmp_path])
    assert report.new == [] and report.suppressed == 1


def test_plain_ruff_noqa_does_not_suppress(tmp_path):
    _write_mod(tmp_path, "import torch  # noqa\n")
    report = analyze_paths([tmp_path])
    assert [v.rule for v in report.new] == ["RPR001"]


# ----------------------------------------------------------------- baseline


def test_baseline_round_trip_add_then_remove(tmp_path):
    mod = _write_mod(tmp_path, "import torch\nn_total = float(w.sum())\n")
    bl = tmp_path / "baseline.txt"

    # 1. violations are new with no baseline
    r1 = analyze_paths([tmp_path])
    assert {v.rule for v in r1.new} == {"RPR001", "RPR003"} and not r1.ok

    # 2. accept them; the run is now clean, and the reference reads the file
    write_baseline(r1.new, bl)
    entries = load_baseline(bl)
    assert len(entries) == 2 and RE.load_baseline(bl) == entries
    r2 = analyze_paths([tmp_path], baseline=entries)
    assert r2.ok and len(r2.baselined) == 2 and not r2.stale_baseline

    # 3. fingerprints are content-based: inserting a line above does not
    #    invalidate the baseline...
    mod.write_text("x = 1\nimport torch\nn_total = float(w.sum())\n")
    r3 = analyze_paths([tmp_path], baseline=entries)
    assert r3.ok and len(r3.baselined) == 2

    # 4. ...but fixing a violation makes its entry stale (remove half)
    mod.write_text("x = 1\nimport torch\n")
    r4 = analyze_paths([tmp_path], baseline=entries)
    assert r4.ok and len(r4.baselined) == 1 and len(r4.stale_baseline) == 1
    assert r4.stale_baseline[0]["rule"] == "RPR003"

    # 5. rewriting the baseline drops the stale entry, keeps justifications
    for fp in entries:
        entries[fp]["comment"] = f"justified {entries[fp]['rule']}"
    write_baseline(r4.baselined, bl, existing=entries)
    entries2 = load_baseline(bl)
    assert len(entries2) == 1
    (meta,) = entries2.values()
    assert meta["rule"] == "RPR001" and meta["comment"] == "justified RPR001"


def test_duplicate_line_occurrences_fingerprint_distinctly(tmp_path):
    _write_mod(tmp_path, "a = float(w.sum())\nb = 1\na = float(w.sum())\n")
    report = analyze_paths([tmp_path])
    fps = [v.fingerprint for v in report.new]
    assert len(fps) == 2 and len(set(fps)) == 2
    assert fps == [v.fingerprint for v in RA.analyze_paths([tmp_path]).new]


def test_malformed_baseline_is_loud(tmp_path):
    bl = tmp_path / "baseline.txt"
    bl.write_text("# header ok\nnot-a-fingerprint RPR001 x.py:1\n")
    with pytest.raises(AnalysisError, match="malformed baseline"):
        load_baseline(bl)


def test_unknown_select_rule_is_loud(tmp_path):
    with pytest.raises(AnalysisError, match="unknown rule"):
        analyze_paths([tmp_path], select={"RPR999"})


def test_syntax_error_is_loud(tmp_path):
    (tmp_path / "bad.py").write_text("def broken(:\n")
    with pytest.raises(AnalysisError, match="syntax error"):
        analyze_paths([tmp_path])


# ---------------------------------------------------- reports, both linters


def _report_key(report) -> dict:
    d = report.to_dict()
    d.pop("elapsed_s")
    return d


def test_fixture_tree_reports_equal_the_reference(tmp_path):
    """Every RPR002-RPR008 fixture as a module of one tree: both linters
    give the same violations (rule, path, line, col, message, fingerprint)
    and the same counts, also through a baseline and a noqa."""
    roots = []
    for i, (_, src, relpath) in enumerate(FIRING + SILENT):
        roots.append(tmp_path / f"f{i:02d}")
        _write_mod(roots[-1], textwrap.dedent(src), relpath)
    roots.append(tmp_path / "noqa")
    _write_mod(roots[-1], "x = float(w.sum())  # repro: noqa RPR003 -- fixture\n")
    port = analyze_paths(roots, select=PARITY_RULES)
    ref = RA.analyze_paths(roots, select=PARITY_RULES)
    assert len(port.new) >= len(FIRING) and port.suppressed == 1
    assert _report_key(port) == _report_key(ref)
    # half of the findings accepted by a baseline that the port writes
    bl = tmp_path / "half.txt"
    write_baseline(port.new[::2], bl)
    assert _report_key(analyze_paths(roots, select=PARITY_RULES,
                                     baseline=load_baseline(bl))) == \
        _report_key(RA.analyze_paths(roots, select=PARITY_RULES,
                                     baseline=RE.load_baseline(bl)))


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_tree_reports_equal_the_reference(tree):
    port = analyze_paths([SRC / tree], select=PARITY_RULES)
    ref = RA.analyze_paths([SRC / tree], select=PARITY_RULES)
    assert port.files == ref.files > 50
    assert _report_key(port) == _report_key(ref)


# -------------------------------------------------------- repo + CLI gates


def test_port_is_clean_under_its_baseline():
    """The acceptance gate, as a test: the port passes its own linter with
    an empty baseline, and every noqa in it names its rule and a reason."""
    entries = load_baseline(PORT_BASELINE)
    assert entries == {}
    report = analyze_paths([SRC / "repro_torch"], baseline=entries)
    assert report.ok, "\n".join(
        f"{v.location}: {v.rule} {v.message}" for v in report.new
    )
    assert not report.baselined and not report.stale_baseline
    assert report.suppressed > 0
    # the analysis package itself quotes the grammar in its docs: skip it
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        if path.parent.name == "analysis":
            continue
        with open(path, "rb") as f:
            comments = [t for t in tokenize.tokenize(f.readline) if t.type == tokenize.COMMENT]
        for tok in comments:
            m = RE._NOQA_RE.search(tok.string)
            if m is not None:
                where = (path, tok.start[0])
                assert m.group("codes"), where
                assert tok.string[m.end():].lstrip().startswith("--"), where
                assert tok.string[m.end():].lstrip()[2:].strip(), where


def test_package_is_stdlib_only():
    """Importing the linter pays neither numpy nor torch, as the
    reference's pays neither numpy nor jax."""
    code = ("import sys, repro_torch.analysis\n"
            "print(sorted({'numpy', 'torch'} & set(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=ENV, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("entry", list(PORT_CLIS))
def test_cli_json_contract(tmp_path, entry):
    _write_mod(tmp_path, "import torch\n")
    proc = subprocess.run(
        [*PORT_CLIS[entry], "--format", "json", "--baseline", "none", str(tmp_path)],
        capture_output=True, text=True, env=ENV, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    data = json.loads(proc.stdout)
    assert data["version"] == 1 and not data["ok"]
    (v,) = data["violations"]
    assert v["rule"] == "RPR001" and v["path"] == "core/mod.py"
    assert v["line"] == 1 and v["fingerprint"]


@pytest.mark.parametrize("entry", list(PORT_CLIS))
def test_cli_exit_codes(tmp_path, entry):
    _write_mod(tmp_path, "x = 1\n")
    ok = subprocess.run([*PORT_CLIS[entry], "--baseline", "none", str(tmp_path)],
                        capture_output=True, text=True, env=ENV, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    usage = subprocess.run([*PORT_CLIS[entry], "--select", "RPR999", str(tmp_path)],
                           capture_output=True, text=True, env=ENV, timeout=120)
    assert usage.returncode == 2
    assert "unknown rule" in usage.stderr


@pytest.mark.parametrize("entry", list(PORT_CLIS))
def test_cli_default_run_is_clean_on_the_port(entry):
    """No arguments: the port's package under ANALYSIS_BASELINE_TORCH.txt."""
    proc = subprocess.run([*PORT_CLIS[entry], "--format", "json"], capture_output=True,
                          text=True, env=ENV, timeout=120, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    counts = json.loads(proc.stdout)["counts"]
    assert counts["new"] == counts["baselined"] == counts["stale_baseline"] == 0
