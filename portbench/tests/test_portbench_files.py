"""The benchmark's files: found by name, a cell added by files alone runs,
nothing loads JAX or the JAX package, the reference imports nothing of
the program, the traffic gives every seed the same work, and the
yardstick's counts."""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
PB = ROOT / "portbench"
BM = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_has_its_file():
    for c in BM["configs"]:
        assert (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and (PB / cfg["reference"]).exists()
    for w in BM["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists()


def test_guard_compares_whole_top_level_names():
    from portbench.guard import forbidden_loaded

    assert forbidden_loaded({"repro_torch": 1, "repro_torch.serve": 1, "jaxtyping": 1}) == []
    assert forbidden_loaded({"repro.core": 1, "jax": 1, "flax.linen": 1}) == ["flax", "jax", "repro"]


SNIPPET = """
import sys, time, json
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench import bench, report, guard
bm = json.loads(open({bm!r}).read())
wl = next(w for w in bm["workloads"] if w["name"] == {cell!r})
rec = bench.run(wl, 3, 1.0, False, device=torch.device("cpu"), t_start=time.monotonic(),
                smoke=True, clock=bench.TickClock(0.01))
line = report.result(bm, wl["name"], rec, False, {{"platform": "cpu"}})
print(json.dumps({{"bad": guard.forbidden_loaded(), "port": "repro_torch" in sys.modules,
                  "metrics": sorted(line["metrics"]), "correct": line["correct"]}}))
"""


def _run_snippet(root: Path, cell: str) -> dict:
    code = SNIPPET.format(root=str(root), src=str(ROOT / "src"), bm=str(root / "BENCHMARK.json"),
                          cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_or_jax_package_loaded():
    got = _run_snippet(ROOT, "glm4-9b.longprompt")
    assert got["bad"] == [] and got["port"] is True


def test_cell_added_as_files_only(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((PB / "traffic" / "longprompt-4k.json").read_text())
    mix["output"] = {"dist": "uniform", "min": 4, "max": 12}
    (tmp_path / "portbench" / "traffic" / "mid-answers.json").write_text(json.dumps(mix))
    bm["workloads"].append({"name": "zamba2-1.2b.mid-answers", "config": "zamba2-1.2b",
                            "traffic": "mid-answers", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    got = _run_snippet(tmp_path, "zamba2-1.2b.mid-answers")
    assert got["correct"] is True
    assert set(got["metrics"]) == {m["name"] for m in bm["end_to_end"]
                                   if "zamba2-1.2b.mid-answers" in m.get("workloads", [
                                       "zamba2-1.2b.mid-answers"])}


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "math", "torch", "portbench"}
    for path in (PB / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, f"{path.name} imports {n}"
                if top == "portbench":
                    assert n.startswith("portbench.reference"), f"{path.name} imports {n}"


def test_every_seed_gets_the_same_work():
    from portbench.traffic import gen

    for mix in ("chat", "longprompt-4k", "longprompt-1k"):
        a, b = gen.draw(mix, 1, 45.0), gen.draw(mix, 2 ** 31 + 5, 45.0)
        assert not np.array_equal(a.prompt_len, b.prompt_len)
        blk = 32 * (a.n // 32)
        for x, y in ((a.prompt_len, b.prompt_len), (a.out_len, b.out_len)):
            assert np.array_equal(np.sort(x[:blk]), np.sort(y[:blk]))
            assert np.array_equal(np.sort(x), np.sort(y))
        if a.t_arrival is not None:
            # n arrivals from 0 use n - 1 of the n quantile gaps
            rate = gen.load(mix)["arrivals"]["rate_per_s"]
            grid = set(np.round(-np.log1p(-(np.arange(a.n) + 0.5) / a.n) / rate, 9))
            for t in (a.t_arrival, b.t_arrival):
                assert t[0] == 0 and len(grid - set(np.round(np.diff(t), 9))) == 1


def test_yardstick_counts():
    from portbench import bench, yardstick

    glm = bench.load_config("glm4-9b")
    # 2 x (40 layers' 203,948,032 weights + the head's 620,756,992) + attention
    # over 1024 keys (4 x 32 heads x 128 x 40 layers x 1024)
    assert yardstick.decode_flops(glm, 1024) == 2 * (40 * 203948032 + 620756992) + 4 * 32 * 128 * 40 * 1024
    # causal halving: twice the prompt costs under four times the attention
    att = lambda s: yardstick.prefill_flops(glm, s) - s * 2 * yardstick.token_matmul_weights(glm)  # noqa: E731
    assert 3.9 < att(2048) / att(1024) < 4.1
    ops, nbytes = yardstick.coded_matvec_decode(14, 16, 10826, 4096, 4)
    t, by = yardstick.bound_s(ops, nbytes)
    assert by == "bytes" and abs(t - 14 * 10826 * 4096 * 4 / 3.35e12) / t < 5e-3
    zam = bench.load_config("zamba2-1.2b")
    assert yardstick.ssd_cells(zam, 4000) == (64 * 16, 256, 64, 64)
    # the shared block counted once an application: 6 of them
    per = yardstick.token_matmul_weights(zam)
    assert per == 38 * yardstick._mamba_weights(zam) + 6 * (
        yardstick._attn_weights(zam) + yardstick._mlp_weights(zam))
