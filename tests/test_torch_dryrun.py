"""The port's dry run against the JAX reference's, on the CPU.

``repro_torch.launch.dryrun`` reckons each (arch x shape x mesh) cell on
the meta device where the reference compiles it for TPU placeholder
devices.  Held here:

  * ``Model.param_shapes``, ``cache_shapes`` and ``input_specs``: every
    leaf's shape and dtype equal to the reference's for all ten configs,
    with and without the coded head; token dtypes map int32 -> int64 for a
    train batch (what the port's train step runs on) and stay int32 for
    prefill and decode (the engine's);
  * ``train_plan`` and ``model_flops`` equal to the reference's for every
    arch x shape, and ``roofline`` with ``HW_V5E`` equal to the reference's
    ``as_dict()`` (its ``tests/test_hlo.py`` case);
  * ``analyze_ops`` on one matmul, its FLOPs against torch's own
    ``FlopCounterMode``, and on small configs the meta count equal to the
    same program's count on CPU tensors;
  * ``run_cell`` in-process (the counterpart of the reference's
    ``tests/test_multidevice.py::test_dryrun_cell_subprocess``, which fails
    under jax 0.9), a failing cell as an ``error`` row, ``--resume`` and
    ``--out`` merging as the reference's do, the ``--dry-run`` listing line
    for line, and no jax after importing the module.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.sharding.policy import _path_str
from repro.utils import hlo as jax_hlo
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import Workload
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import build_model
from repro_torch.utils import hlo
from repro_torch.utils.tree import tree_flatten_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_reference_dryrun():
    """The reference's dry-run module sets XLA_FLAGS to 512 host devices
    when imported (for its own process); the flags are put back at once,
    before jax starts a backend here."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


jax_dryrun = _import_reference_dryrun()
# the port's token dtypes where they differ from the reference's int32
TOKEN_DTYPES = {"train": "int64", "prefill": "int32", "decode": "int32"}


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in flat}


def _my_leaves(tree) -> dict:
    out = {}
    for p, x in tree_flatten_with_path(tree):
        assert x.device.type == "meta", p
        out[p] = (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    return out


# --------------------------------------------------------------------------
# shapes without memory
# --------------------------------------------------------------------------
@pytest.mark.parametrize("coded", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_shapes_equal_the_references(arch, coded):
    rcfg, mcfg = jax_config(arch), get_config(arch)
    if coded:
        rcfg, mcfg = rcfg.scaled(coded=True), mcfg.scaled(coded=True)
    ref, mine = jax_build(rcfg), build_model(mcfg)
    assert _my_leaves(mine.param_shapes()) == _ref_leaves(ref.param_shapes())
    for batch, seq in ((4, 128), (128, 32768)):
        assert (_my_leaves(mine.cache_shapes(batch, seq))
                == _ref_leaves(ref.cache_shapes(batch, seq)))
    for kind, tok in TOKEN_DTYPES.items():
        want = _ref_leaves(ref.input_specs(kind, 4, 128))
        for name in ("tokens", "labels"):
            if name in want:
                want[name] = (want[name][0], tok)
        assert _my_leaves(mine.input_specs(kind, 4, 128)) == want, kind
    with pytest.raises(ValueError):
        mine.input_specs("serve", 1, 1)


def _draw_bounds():
    from repro_torch.models import layers

    return 2.0 * layers._LO - 1.0, 2.0 * layers._HI - 1.0


def test_meta_init_draws_nothing_and_seeded_init_is_unchanged():
    """``init(device="meta")`` takes no generator; a seeded init on the CPU
    gives the same bits as before the meta path existed (a draw on the
    generator, then a cast)."""
    from repro_torch.models.layers import truncated_normal

    model = build_model(get_config("glm4-9b", smoke=True).scaled(coded=True))
    shapes = model.param_shapes()
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert _my_leaves(shapes) == {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                                  for p, x in tree_flatten_with_path(params)}
    g = torch.Generator().manual_seed(5)
    got = truncated_normal((64, 32), 0.5, torch.bfloat16, g, "cpu")
    g = torch.Generator().manual_seed(5)
    t = torch.empty((64, 32), dtype=torch.float32)
    lo, hi = _draw_bounds()
    t.uniform_(lo, hi, generator=g)
    t.erfinv_().mul_(0.5 * np.sqrt(2.0)).clamp_(-1.0, 1.0)
    assert torch.equal(got, t.to(torch.bfloat16))


# --------------------------------------------------------------------------
# plan, analytic FLOPs, roofline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_train_plan_and_model_flops_equal_the_references(arch):
    assert list(ARCHS) == list(JAX_ARCHS) and list(SHAPES) == list(JAX_SHAPES)
    mine, ref = get_config(arch), jax_config(arch)
    assert dryrun.train_plan(mine) == jax_dryrun.train_plan(ref)
    for shape in SHAPES:
        a = dryrun.model_flops(mine, SHAPES[shape])
        b = jax_dryrun.model_flops(ref, JAX_SHAPES[shape])
        assert a == b and type(a) is type(b), (arch, shape)


def test_roofline_terms_equal_the_references():
    """tests/test_hlo.py::test_roofline_terms, on both packages with HW_V5E."""
    for args in ({"flops": 197e12, "hbm_bytes": 819e9, "wire_bytes": 50e9,
                  "model_flops": 98.5e12},
                 {"flops": 1e12, "hbm_bytes": 819e9 * 3, "wire_bytes": 0}):
        mine = hlo.roofline(**args, hw=hlo.HW_V5E)
        ref = jax_hlo.roofline(**args)
        assert mine.as_dict() == ref.as_dict()
    rl = hlo.roofline(flops=197e12, hbm_bytes=819e9, wire_bytes=50e9, model_flops=98.5e12,
                      hw=hlo.HW_V5E)
    assert rl.compute_s == pytest.approx(1.0) and rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(1.0)
    assert rl.useful_fraction == pytest.approx(0.5) and rl.mfu_bound == pytest.approx(0.5)
    assert hlo.roofline(flops=1e12, hbm_bytes=819e9 * 3, wire_bytes=0,
                        hw=hlo.HW_V5E).dominant == "memory"


def test_roofline_on_the_h100_by_dtype_and_without_collectives():
    h = hlo.HW_H100
    assert (h.peak_flops, h.fp32_flops, h.hbm_bw, h.ici_bw) == (989e12, 67e12, 3.35e12, 450e9)
    assert "H100" in h.name and "700 W" in h.name
    rl = hlo.roofline(flops=989e12 + 67e12, hbm_bytes=3.35e12, wire_bytes=None,
                      model_flops=989e12, hw=h,
                      flops_by_dtype={"bfloat16": 989e12, "float32": 67e12})
    assert rl.compute_s == pytest.approx(2.0) and rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s is None and rl.wire_bytes == 0.0
    assert rl.dominant == "compute" and rl.bound_s == pytest.approx(2.0)
    # the port's mfu_bound uses the hardware it was given (the reference's the v5e)
    assert rl.mfu_bound == pytest.approx(0.5)
    assert rl.as_dict()["collective_s"] is None
    # bf16-only counts: the reference's formula
    assert hlo.roofline(2e12, 0.0, None, hw=h, flops_by_dtype={"bfloat16": 2e12}).compute_s \
        == hlo.roofline(2e12, 0.0, None, hw=h).compute_s


# --------------------------------------------------------------------------
# op counting
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_analyze_ops_counts_one_matmul(dtype):
    m, k, n = 96, 64, 40
    a = torch.empty(m, k, dtype=dtype, device="meta")
    b = torch.empty(k, n, dtype=dtype, device="meta")
    c = hlo.analyze_ops(torch.matmul, a, b)
    size = torch.empty((), dtype=dtype).element_size()
    assert c.flops == 2 * m * n * k
    assert c.flops_by_dtype == {str(dtype).removeprefix("torch."): 2 * m * n * k}
    assert c.hbm_bytes == (m * k + k * n + m * n) * size and c.ops == 1
    assert c.outputs.shape == (m, n) and c.outputs.device.type == "meta"
    # views move nothing, an indexed write counts what it writes
    x = torch.empty(1000, 64, device="meta")
    assert hlo.analyze_ops(lambda t: t.reshape(-1)[:10].unsqueeze(0).T, x).hbm_bytes == 0
    # a reshape that must copy moves what it copies, read and written
    assert hlo.analyze_ops(lambda t: t.T.reshape(-1), x).hbm_bytes == 2 * 1000 * 64 * 4
    idx = torch.zeros(3, dtype=torch.long, device="meta")
    vals = torch.empty(3, 64, device="meta")
    got = hlo.analyze_ops(lambda t: t.index_copy_(0, idx, vals), x).hbm_bytes
    assert got == 3 * 8 + 2 * 3 * 64 * 4


def _count(fn, *args):
    with FlopCounterMode(display=False) as fc:
        c = hlo.analyze_ops(fn, *args)
    return c, fc.get_total_flops()


@pytest.mark.parametrize("arch,coded", [("glm4-9b", False), ("glm4-9b", True),
                                        ("zamba2-1.2b", False), ("dbrx-132b", False),
                                        ("seamless-m4t-large-v2", False)])
def test_meta_count_equals_the_cpu_count(arch, coded):
    """The same program counted on meta and on CPU tensors (a smoke config):
    FLOPs equal, and torch's FlopCounterMode's total; bytes and ops equal
    but for the coded head's recovery table, which a CUDA or meta device
    uploads from the host (a copy that is no op on the CPU)."""
    cfg = get_config(arch, smoke=True)
    if coded:
        cfg = cfg.scaled(coded=True)
    model = build_model(cfg)
    counts = {}
    for dev in ("meta", "cpu"):
        params = model.init(torch.Generator().manual_seed(0) if dev == "cpu" else None,
                            device=dev)
        cache = model.init_cache(2, 32, device=dev)
        tokens = torch.zeros(2, dtype=torch.int32, device=dev)
        with torch.no_grad():
            counts[dev] = _count(model.decode_step, params, cache, tokens)
    (meta, meta_fc), (cpu, cpu_fc) = counts["meta"], counts["cpu"]
    assert meta.flops == cpu.flops == meta_fc == cpu_fc > 0
    assert meta.flops_by_dtype == cpu.flops_by_dtype
    if not coded:
        assert (meta.hbm_bytes, meta.ops) == (cpu.hbm_bytes, cpu.ops)
    else:
        assert meta.hbm_bytes > cpu.hbm_bytes and meta.ops > cpu.ops


def test_train_cell_count_equals_the_cpu_count():
    """A whole train step (microbatches, remat, AdamW) of a smoke config,
    built by ``build_cell`` on meta and on the CPU."""
    cfg = get_config("mamba2-130m", smoke=True)
    wl = Workload("t", "train", 32, 4)
    mesh = make_mesh((1, 1), ("data", "model"))
    counts = []
    for dev in ("meta", "cpu"):
        fn, args, _ = dryrun.build_cell(cfg, wl, mesh, device=dev,
                                        overrides={"microbatches": 2},
                                        generator=torch.Generator().manual_seed(0)
                                        if dev == "cpu" else None)
        counts.append(_count(fn, *args))
    (meta, meta_fc), (cpu, cpu_fc) = counts
    assert meta.flops == cpu.flops == meta_fc == cpu_fc > 0
    assert (meta.hbm_bytes, meta.ops) == (cpu.hbm_bytes, cpu.ops)


# --------------------------------------------------------------------------
# cells and the launcher
# --------------------------------------------------------------------------
def test_run_cell_in_process_both_meshes():
    rows = dryrun.run_cells("mamba2-130m", "decode_32k", (False, True))
    assert [r["status"] for r in rows] == ["ok", "ok"]
    assert [r["chips"] for r in rows] == [256, 512]
    one, two = rows
    # counted once, reckoned under both meshes
    for k in ("flops", "flops_by_dtype", "hbm_bytes", "ops"):
        assert one["cost"][k] == two["cost"][k], k
    assert one["count_s"] == two["count_s"]
    assert one["cost"]["per_device_flops"] * 256 == one["cost"]["flops"]
    assert one["memory"]["temp_size_in_bytes"] is None
    assert 0 < two["memory"]["argument_size_in_bytes"] < one["memory"]["argument_size_in_bytes"]
    rl = one["roofline"]
    assert rl["collective_s"] is None and rl["wire_bytes"] == 0.0
    assert rl["flops"] == one["cost"]["flops"] / 256
    assert rl["model_flops"] == dryrun.model_flops(get_config("mamba2-130m"),
                                                   SHAPES["decode_32k"]) / 256
    assert one["hints"]["act_bsd"] == ["data", None, None]
    assert two["hints"]["act_bsd"] == [("pod", "data"), None, None]
    assert one["hw"] == hlo.HW_H100.name and "not measured" in one["basis"]
    json.dumps(rows)  # a row is JSON as it stands
    skipped = dryrun.run_cell("glm4-9b", "long_500k", False)
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]
    assert dryrun.run_cell("mamba2-130m", "decode_32k", True)["memory"] == two["memory"]


def test_argument_bytes_on_a_one_device_mesh_are_the_tensors_bytes():
    """On a 1 x 1 mesh every spec divides by 1: the reckoned argument bytes
    are the arguments' own, which the card's run is held to."""
    cfg = get_config("mamba2-130m", smoke=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    for wl in (Workload("d", "decode", 64, 3), Workload("p", "prefill", 32, 1),
               Workload("t", "train", 32, 2)):
        res, _ = dryrun.reckon(cfg, wl, mesh, coded=True)
        _, args, _ = dryrun.build_cell(cfg, wl, mesh, coded=True, device="cpu")
        total = sum(x.numel() * x.element_size()
                    for a in args for _, x in tree_flatten_with_path(a))
        assert res["memory"]["argument_size_in_bytes"] == total, wl.kind


def test_a_failing_cell_is_an_error_row():
    rows = dryrun.run_cells("mamba2-130m", "train_4k", (False, True),
                            overrides={"microbatches": 3})
    for row in rows:
        assert row["status"] == "error" and "divisible" in row["error"]
        assert "Traceback" in row["trace"]


def test_out_and_resume_merge(tmp_path, capsys):
    out = tmp_path / "dry.json"
    out.write_text(json.dumps([{"arch": "other", "shape": "x", "multi_pod": False,
                                "coded": False, "status": "ok"}]))
    base = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--out", str(out)]
    dryrun.main(base)
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["multi_pod"]) for r in rows] == [("other", False),
                                                           ("mamba2-130m", False)]
    capsys.readouterr()
    dryrun.main(base + ["--multi-pod", "both", "--resume"])
    text = capsys.readouterr().out
    assert "resume: 2 cells already complete" in text and text.count(": OK") == 1
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["multi_pod"]) for r in rows] == [
        ("other", False), ("mamba2-130m", False), ("mamba2-130m", True)]
    dryrun.main(base + ["--out", ""])  # no report
    assert len(json.loads(out.read_text())) == 3


def test_dry_run_listing_equals_the_references():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    outs = []
    for pkg in ("repro", "repro_torch"):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun", "--dry-run",
                              "--multi-pod", "both", "--coded"],
                             capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append(res.stdout)
    assert outs[0] == outs[1]
    assert "[dryrun] --dry-run: 64 compilable cells resolved" in outs[1]


def test_dryrun_imports_no_jax():
    code = ("import sys, repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
