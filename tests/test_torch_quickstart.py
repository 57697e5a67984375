"""examples/quickstart_torch.py against examples/quickstart.py: the same
source and options, bit-equal labels in all five runs against
`repro.api.partition`, and the reference script's printed lines; the
script runs on the card by default and refuses to start without one."""
import ast
import contextlib
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as RA

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
REF_SCRIPT = ROOT / "examples" / "quickstart.py"
PORT_SCRIPT = ROOT / "examples" / "quickstart_torch.py"
#: the five runs of the reference script: name -> extra API keywords
RUNS = {
    "buffcut": dict(driver="buffcut"),
    "heistream": dict(driver="heistream"),
    "fennel": dict(driver="fennel"),
    "buffcut+restream": dict(driver="buffcut", restream_passes=1),
    "…priority": dict(driver="buffcut", restream_passes=1, restream_order="priority"),
}


def _load_port_example():
    spec = importlib.util.spec_from_file_location("quickstart_torch", PORT_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_settings() -> tuple[str, dict]:
    """SOURCE and OPTS as the reference script states them (it runs its
    partitions at import, so they are read from its source)."""
    source, opts = None, None
    for node in ast.parse(REF_SCRIPT.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "SOURCE":
                source = ast.literal_eval(node.value)
            elif name == "OPTS":
                opts = {kw.arg: ast.literal_eval(kw.value) for kw in node.value.keywords}
    return source, opts


@pytest.fixture(scope="module")
def port_run():
    mod = _load_port_example()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = mod.main(device="cpu")
    return mod, results, buf.getvalue().splitlines()


def test_same_source_and_options(port_run):
    mod = port_run[0]
    assert (mod.SOURCE, mod.OPTS) == _reference_settings()


def test_five_runs_bit_equal_to_the_reference(port_run):
    mod, results = port_run[0], port_run[1]
    assert list(results) == list(RUNS)
    for name, extra in RUNS.items():
        ref = RA.partition(mod.SOURCE, **extra, **mod.OPTS)
        res = results[name]
        assert np.array_equal(res.labels, ref.labels), name
        assert res.provenance["device"] == "cpu", name
        assert (res.cut_ratio, res.balance, res.ier) == (ref.cut_ratio, ref.balance, ref.ier), name


def test_printed_lines_equal_the_reference_script(port_run):
    lines = port_run[2]
    ref = subprocess.run([sys.executable, str(REF_SCRIPT)], capture_output=True, text=True,
                         cwd=ROOT, env=ENV, timeout=300)
    assert ref.returncode == 0, ref.stderr
    # the port adds one line: where the five runs ran
    assert lines == ref.stdout.splitlines()[:-1] + ["device=cpu (5 runs)", "OK"]


def test_script_runs_on_the_host_and_defaults_to_the_card():
    host = subprocess.run([sys.executable, str(PORT_SCRIPT), "--device", "cpu"],
                          capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)
    assert host.returncode == 0, host.stderr
    assert host.stdout.splitlines()[-2:] == ["device=cpu (5 runs)", "OK"]
    card = subprocess.run([sys.executable, str(PORT_SCRIPT)], capture_output=True, text=True,
                          cwd=ROOT, env={**ENV, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert card.returncode != 0 and "no CUDA device" in card.stderr
    assert "OK" not in card.stdout.split()
