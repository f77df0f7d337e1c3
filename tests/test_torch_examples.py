"""The port's EC2 example (``examples/ec2_repro_torch.py``) against the
reference's (``examples/ec2_repro.py``) at a tiny size on the CPU.

The tasks run in model time on the same seeds, so the printed tables — mean
completion times in model seconds and the best scheme of each scenario —
must be equal letter for letter, whether the port's master encodes Â on the
host (``--encode-mode none``) or through the kernels' plain versions on the
CPU (``--encode-mode device --device cpu``).
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
TINY = ["--scale", "100", "--trials", "1", "--m", "64"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_tables():
    mod, out, argv = _load("ec2_repro"), io.StringIO(), sys.argv
    sys.argv = ["ec2_repro.py", *TINY]  # the reference's main reads sys.argv
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    return out.getvalue()


@pytest.mark.parametrize("mode", ["none", "device"])
def test_ec2_example_prints_the_reference_tables(reference_tables, mode):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        records = _load("ec2_repro_torch").main([*TINY, "--device", "cpu", "--encode-mode", mode])
    assert "scenario 4 (r=200, N=15)" in reference_tables
    assert out.getvalue() == reference_tables
    # 4 scenarios and 4 straggler probabilities, 4 schemes, 1 trial
    assert len(records) == 32 and all(rec["ok"] for rec in records)
    for rec in records:
        if rec["scheme"] in ("hcmm", "bpcc") and mode == "device":
            enc = rec["encode"]
            assert enc["device"] == "cpu" and enc["rows"] == rec["rows_assigned"] > 0, rec
            assert enc["reserve_rows"] == 0, rec  # the static task: no top-ups
        else:
            assert rec["encode"] is None, rec


def test_ec2_example_imports_neither_jax_nor_reference():
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({os.path.join(EXAMPLES, 'ec2_repro_torch.py')!r}, run_name='ex')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    src = os.path.join(os.path.dirname(EXAMPLES), "src")
    res = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
