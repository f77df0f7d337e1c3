"""The port's per-shape dispatch (``kernel_mode='auto'``) against the JAX reference.

``repro_torch.kernels.cost`` on the ``'cpu'`` backend is the reference's
cost model, number for number; on ``'cuda'`` its candidates are the
hand-written kernels, each at its own launch plan (no launch parameters).
``repro_torch.kernels.dispatch`` is held to the reference's own dispatch
tests (``tests/test_autotune.py``), ported: table round trip, fallbacks to
the model, refused entries, the env override, the contexts.  ``'auto'`` is
bit-equal to the explicit mode it resolves to, on every entry point the
reference accepts it (CPU tensors: the plain versions), and the engine and
the task form under ``'auto'`` reproduce their default runs.  The committed
table (``reports/bench/cuda/autotune.json``, measured on the H100) is
checked for health here, as JSON.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from repro.kernels import cost as rcost
from repro.kernels.dispatch import choose_coded_linear as ref_choose_coded_linear
from repro.models.registry import build_model as jax_build
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.configs import get_config as jax_config
from repro_torch.cluster import ClusterEmulator, TaskSpec, ec2_scenario
from repro_torch.configs import get_config
from repro_torch.core import adaptive
from repro_torch.core.adaptive import ParityController
from repro_torch.core.coded_ops import CodedLinear
from repro_torch.core.encoding import GaussianCode, LTCode
from repro_torch.kernels import autotune, cost, dispatch, ops
from repro_torch.kernels.dispatch import (
    Decision,
    DispatchTable,
    choose_coded_linear,
    choose_encode,
    choose_matvec,
    default_table_path,
    set_table_path,
)
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.sharding import HeadMesh
from repro_torch.sharding import ctx
from repro_torch.weights import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "reports", "bench", "cuda", "autotune.json")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _restore_table():
    """Every test leaves the dispatch singleton pointing at the default."""
    yield
    set_table_path(None)


# --------------------------------------------------------------------------
# the cost model on 'cpu': the reference's numbers
# --------------------------------------------------------------------------
GEOMS = {
    "coded_linear": [dict(out=1024, inner=256, batch=8, n_data=12, n_parity=4),
                     dict(out=256, inner=512, batch=4, n_data=12, n_parity=4),
                     dict(out=4096, inner=1024, batch=8, n_data=12, n_parity=4),
                     dict(out=151564, inner=4096, batch=4, n_data=14, n_parity=2),
                     dict(out=100, inner=7, batch=1, n_data=6, n_parity=2)],
    "coded_matvec": [dict(r=2048, m=1024, b=8), dict(r=512, m=512, b=4),
                     dict(r=10826, m=4096, b=1)],
    "coded_matvec_decode": [dict(rows=160, m=64, b=4, n_data=12, n_blocks=16),
                            dict(rows=173216, m=4096, b=1, n_data=14, n_blocks=16)],
    "gaussian_encode": [dict(q=256, r=1024, m=2048), dict(q=64, r=256, m=512),
                        dict(q=16, r=13, m=47751168)],
    "lt_encode": [dict(q=2672, r=5000, m=500000, d_max=40), dict(q=64, r=100, m=1000, d_max=5)],
}
CASES = [(op, g) for op, gs in GEOMS.items() for g in gs]
FIELDS = ("flops", "bytes", "nodes", "svd_n3", "grid_steps")


@pytest.mark.parametrize("macro_k", [1, 4])
@pytest.mark.parametrize("op,geom", CASES)
def test_cpu_cost_model_equals_reference(op, geom, macro_k):
    mine = cost.candidate_costs(op, "cpu", **geom)
    ref = rcost.candidate_costs(op, "cpu", **geom)
    assert list(mine) == list(ref)
    hw, rhw = cost.preset("cpu"), rcost.preset("cpu")
    assert hw.as_dict() == rhw.as_dict()
    for impl in ref:
        assert [getattr(mine[impl], f) for f in FIELDS] == [getattr(ref[impl], f) for f in FIELDS]
        assert mine[impl].predicted_us(hw) == ref[impl].predicted_us(rhw)
        assert mine[impl].predicted_block_us(hw, macro_k) == ref[impl].predicted_block_us(rhw, macro_k)
    assert (cost.predict_best(op, "cpu", macro_k=macro_k, **geom)
            == rcost.predict_best(op, "cpu", macro_k=macro_k, **geom))


# --------------------------------------------------------------------------
# the card's candidates: kernels only, presets
# --------------------------------------------------------------------------
KERNEL_CASES = [(op, g) for op, g in autotune.cells() if op != "lt_encode"] + [
    ("coded_matvec", dict(r=77, m=4100, b=16)), ("coded_matvec", dict(r=1, m=1, b=1)),
    ("coded_linear", dict(out=515, inner=130, batch=4, n_data=14, n_parity=2)),
    ("coded_linear", dict(out=120, inner=6144, batch=16, n_data=13, n_parity=3)),
    ("gaussian_encode", dict(q=70, r=2000, m=260)), ("gaussian_encode", dict(q=1, r=1, m=4)),
    # x wider than one launch: column panels (the mamba2-130m head at B = 128)
    ("coded_matvec", dict(r=1001, m=4096, b=33)),
    ("coded_linear", dict(out=50280, inner=768, batch=128, n_data=14, n_parity=2)),
]


def _choose(op, geom, backend):
    if op == "coded_linear":
        return choose_coded_linear(**geom, backend=backend)
    if op == "coded_matvec":
        return choose_matvec(**geom, backend=backend)
    return choose_encode("gaussian", **geom, backend=backend)


@pytest.mark.parametrize("op,geom", KERNEL_CASES)
def test_cuda_model_decides_among_kernels_without_launch_parameters(op, geom, tmp_path):
    """With no table, every decision on the card is a kernel at its own
    launch plan (no params), priced above the dispatch floor; on the CPU
    it is the plain version, as the reference's model picks it."""
    set_table_path(str(tmp_path / "none.json"))
    costs = cost.candidate_costs(op, "cuda", **geom)
    assert list(costs) == (["fused", "svd"] if op == "coded_linear" else ["cuda"])
    impl, us, params = cost.predict_best(op, "cuda", **geom)
    assert impl == ("fused" if op == "coded_linear" else "cuda") and params == {}
    assert us > cost.H100_HOST.dispatch_us
    d = _choose(op, geom, "cuda")
    assert (d.source, d.impl, d.mode, d.params) == ("model", impl, "cuda", {})
    on_cpu = _choose(op, geom, "cpu")
    assert on_cpu.params == {} and on_cpu.mode in ("off", None)
    assert on_cpu.impl == rcost.predict_best(op, "cpu", **geom)[0]


def test_presets_name_the_h100_and_refuse_other_backends():
    assert cost.preset("cuda") is cost.H100_HOST
    assert cost.preset("cpu") is cost.CPU_HOST
    hw = cost.H100_HOST
    assert (hw.gemm_flops, hw.mem_bw, hw.overlap) == (67e12, 3.35e12, True)
    for backend in ("tpu", "gpu", "rocm"):
        with pytest.raises(ValueError, match="backend"):
            cost.preset(backend)
    assert not hasattr(cost, "TPU_V5E_HOST") and not hasattr(cost, "VMEM_BYTES")


@pytest.mark.parametrize("macro_k", [1, 16])
def test_cuda_candidates_are_kernels(macro_k):
    """Both recovery sources are kernels a CUDA graph holds, so a fused
    block of any length ranks the same two candidates."""
    geom = GEOMS["coded_linear"][3]
    costs = cost.candidate_costs("coded_linear", "cuda", **geom)
    assert list(costs) == ["fused", "svd"]
    impl, us, params = cost.predict_best("coded_linear", "cuda", macro_k=macro_k, **geom)
    assert impl == "fused" and us > 0 and params == {}
    for op in ("coded_matvec", "coded_matvec_decode", "gaussian_encode", "lt_encode"):
        g = GEOMS[op][-1]
        impl, _, params = cost.predict_best(op, "cuda", **g)
        assert impl == "cuda" and list(cost.candidate_costs(op, "cuda", **g)) == ["cuda"]
        assert params == {}


@pytest.mark.parametrize("b,reads", [(1, 1), (16, 1), (17, 1), (33, 1), (128, 1), (300, 2)])
def test_cuda_costs_count_the_head_kernels_panels(b, reads):
    """A head kernel is one launch at any width of x.  From WIDE_MIN_B
    columns it runs on the wide engine: the card's costs count one more node
    (the split of x), x's pieces written and read once, one read of the
    weight a column tile of 256, and six bf16 products an fp32 one on the
    tensor cores; below WIDE_MIN_B they cost as before."""
    from repro_torch.kernels.wide_rows import WIDE_MIN_B, wide_plan

    wide = b >= WIDE_MIN_B
    assert wide_plan(16 * 3592, 768, b, sm_count=132, nb=16, n_data=14).weight_reads == reads
    one = {"coded_matvec": cost.matvec_costs(1001, 4096, 1, "cuda")["cuda"],
           "coded_matvec_decode": cost.matvec_decode_costs(16 * 3592, 768, 1, 14, 16,
                                                           "cuda")["cuda"],
           "coded_linear": cost.coded_linear_costs(14 * 3592, 768, 1, 14, 2, "cuda")["fused"]}
    at_b = {"coded_matvec": cost.matvec_costs(1001, 4096, b, "cuda")["cuda"],
            "coded_matvec_decode": cost.matvec_decode_costs(16 * 3592, 768, b, 14, 16,
                                                            "cuda")["cuda"],
            "coded_linear": cost.coded_linear_costs(14 * 3592, 768, b, 14, 2, "cuda")["fused"]}
    w_bytes = {"coded_matvec": 4 * 1001 * 4096, "coded_matvec_decode": 4 * 16 * 3592 * 768,
               "coded_linear": 4 * 16 * 3592 * 768}
    x_bytes = {"coded_matvec": 4 * 4096 * b, "coded_matvec_decode": 4 * 768 * b,
               "coded_linear": 4 * 768 * b}
    gemm = {"coded_matvec": 2 * 1001 * 4096 * b, "coded_matvec_decode": 2 * 16 * 3592 * 768 * b,
            "coded_linear": 2 * 16 * 3592 * 768 * b}
    hw = cost.H100_HOST
    for op, c in at_b.items():
        assert c.nodes - one[op].nodes == (1 if wide else 0), op
        assert c.bytes >= reads * w_bytes[op] + (3 * x_bytes[op] if wide else 0), op
        assert c.bytes < (reads + 1) * w_bytes[op] + 5 * x_bytes[op], op
        scale = 6 * 67 / 989 if wide else 1.0
        assert c.flops == pytest.approx(scale * gemm[op], rel=0.2), op
        assert c.predicted_us(hw) >= hw.dispatch_us + reads * w_bytes[op] / hw.mem_bw * 1e6
    # 'auto' resolves at any width on both backends
    d = choose_coded_linear(14 * 3592, 768, b, 14, 2, backend="cuda")
    assert (d.impl, d.mode) == ("fused", "cuda")
    assert choose_matvec(1001, 4096, b, backend="cuda").mode == "cuda"


# --------------------------------------------------------------------------
# dispatch resolution (the reference's tests/test_autotune.py, ported)
# --------------------------------------------------------------------------
def _apply_setup(out=256, inner=128, b=4, n_data=12, n_parity=4, seed=0):
    rng = np.random.default_rng(seed)
    cl = CodedLinear(n_data=n_data, n_parity=n_parity, out_features=out)
    w = rng.standard_normal((out, inner)).astype(np.float32)
    wc = cl.encode(torch.from_numpy(w))
    x = torch.from_numpy(rng.standard_normal((inner, b)).astype(np.float32))
    m = torch.ones(n_data + n_parity)
    m[[1, 7]] = 0.0
    return cl, w, wc, x, m


def _entry(op="coded_linear", backend="cuda", shape="151564x4096x4", impl="fused",
           mode="cuda", params=None, **kw):
    e = {"op": op, "backend": backend, "shape": shape, "dtype": "float32",
         "geometry": {"n_data": 14, "n_parity": 2} if op == "coded_linear" else {},
         "impl": impl, "mode": mode, "params": {} if params is None else params,
         "us": 900.0, "predicted_us": 880.0, "source": "measured"}
    e.update(kw)
    return e


def _table(tmp_path, entries, hardware=None, name="autotune.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"version": 1, "hardware": hardware or {}, "entries": entries}))
    set_table_path(str(p))
    return p


def _measured_doc():
    """A table as the autotuner writes it, from made-up timings."""
    measured = []
    for op, geom in autotune.cells(quick=True):
        impls = ("fused", "svd") if op == "coded_linear" else ("cuda",)
        rows = [{"impl": impl, "mode": "cuda", "params": {}, "us": 1000.0 + 300 * (impl == "svd")}
                for impl in impls]
        measured.append({"op": op, "geometry": geom, "candidates": rows, "library_us": 1500.0,
                         "library_call": "torch.matmul"})
    return autotune.build_table(measured, {"card": "NVIDIA H100 80GB HBM3, 700.00 W"})


def test_table_roundtrip_identical_decisions(tmp_path):
    """Save -> load -> every cell resolves to the same table decision."""
    doc = _measured_doc()
    first = autotune.write_table(doc, tmp_path / "a.json")
    set_table_path(str(first))
    calls = [lambda: choose_coded_linear(151564, 4096, 4, 14, 2, backend="cuda"),
             lambda: choose_matvec(10826, 4096, 4, backend="cuda"),
             lambda: choose_encode("gaussian", 16, 13, 47751168, backend="cuda")]
    before = [c() for c in calls]
    copy = tmp_path / "b.json"
    copy.write_text(json.dumps(json.loads(first.read_text())))
    set_table_path(str(copy))
    after = [c() for c in calls]
    assert before == after
    assert all(d.source == "table" and d.mode == "cuda" for d in before)
    # the winners are the fastest measured candidates
    for d, e in zip(before, doc["entries"]):
        assert (d.impl, d.params, d.measured_us) == (e["impl"], {}, e["us"])
        assert e["us"] == min(c["us"] for c in e["candidates"])


@pytest.mark.parametrize("content", [None, "{not json", "[]", '{"version": 2, "entries": []}'])
def test_missing_or_corrupt_table_falls_back_to_model(tmp_path, content):
    p = tmp_path / "autotune.json"
    if content is not None:
        p.write_text(content)
    set_table_path(str(p))
    d = choose_coded_linear(1024, 256, 8, 12, 4, backend="cpu")
    assert d.source == "model" and d.predicted_us > 0
    assert choose_matvec(512, 512, 4, backend="cuda").source == "model"
    # and apply still computes the right thing through the fallback
    cl, w, wc, x, m = _apply_setup()
    got = cl.apply(wc, x, m, kernel_mode="auto").numpy()
    np.testing.assert_allclose(got, w @ x.numpy(), rtol=1e-4, atol=1e-3)


def test_unseen_shape_uses_model_fallback(tmp_path):
    """A real table that has never seen the shape -> the model, priced with
    the table's hardware constants; a geometry mismatch is a miss too."""
    hw = dict(cost.H100_HOST.as_dict(), dispatch_us=1234.0)
    _table(tmp_path, [_entry()], hardware={"cuda": hw})
    hit = choose_coded_linear(151564, 4096, 4, 14, 2, backend="cuda")
    miss = choose_coded_linear(999, 333, 2, 14, 2, backend="cuda")
    assert hit.source == "table" and hit.measured_us == 900.0
    assert miss.source == "model" and miss.impl == "fused" and miss.predicted_us > 1234.0
    other_geom = choose_coded_linear(151564, 4096, 4, 13, 3, backend="cuda")
    assert other_geom.source == "model"


@pytest.mark.parametrize("impl,mode", [("ref", "off"), ("pallas", "interpret"), ("fused", "off"),
                                       ("default", None), ("library", "cuda"),
                                       ("fused", "interpret"), ("cuda", "cuda")])
def test_plain_library_and_interpreter_entries_are_never_dispatched_on_cuda(tmp_path, impl, mode):
    """On the card a table may only name the op's kernels; anything else
    (a plain version, a library call, the interpreter, another op's impl)
    falls through to the model, which names a kernel."""
    _table(tmp_path, [_entry(impl=impl, mode=mode)])
    d = choose_coded_linear(151564, 4096, 4, 14, 2, backend="cuda")
    assert d.source == "model" and d.impl == "fused" and d.mode == "cuda"


@pytest.mark.parametrize("op,shape,call", [
    ("coded_matvec", "512x512x4", lambda b: choose_matvec(512, 512, 4, backend=b)),
    ("gaussian_encode", "16x13x700", lambda b: choose_encode("gaussian", 16, 13, 700, backend=b)),
])
@pytest.mark.parametrize("impl,mode", [("ref", "off"), ("pallas", "interpret")])
def test_kernel_op_entries_refused_on_both_backends(tmp_path, op, shape, call, impl, mode):
    _table(tmp_path, [_entry(op=op, shape=shape, impl=impl, mode=mode),
                      _entry(op=op, shape=shape, backend="cpu", impl=impl, mode=mode)])
    on_card = call("cuda")
    assert on_card.source == "model" and (on_card.impl, on_card.mode) == ("cuda", "cuda")
    on_cpu = call("cpu")
    if mode == "interpret":   # the reference's rule on every backend
        assert on_cpu.source == "model" and on_cpu.mode == "off"
    else:                     # a plain CPU row is the CPU's own choice
        assert on_cpu.source == "table" and on_cpu.mode == "off"


def test_svd_winner_gives_way_inside_a_fused_block(tmp_path):
    """It no longer gives way: svd_recovery's matrix comes from the
    masked_pinv kernel, which a CUDA graph holds, so a measured svd winner
    is the decision inside a fused block as out of one, as in the
    reference."""
    cands = [{"impl": "fused", "mode": "cuda", "params": {}, "us": 850.0},
             {"impl": "svd", "mode": "cuda", "params": {}, "us": 800.0}]
    _table(tmp_path, [_entry(impl="svd", candidates=cands)])
    scalar = choose_coded_linear(151564, 4096, 4, 14, 2, backend="cuda")
    assert (scalar.impl, scalar.kernel_mode, scalar.source) == ("svd", "svd", "table")
    block = choose_coded_linear(151564, 4096, 4, 14, 2, backend="cuda", macro_k=16)
    assert (block.impl, block.kernel_mode, block.measured_us, block.source) == (
        "svd", "svd", scalar.measured_us, "table")
    assert block is not scalar   # memoized per macro_k all the same


def test_uncacheable_geometry_stays_on_default():
    for backend in ("cpu", "cuda"):
        d = choose_coded_linear(64, 32, 2, 19, 2, backend=backend)
        assert d.impl == "default" and d.kernel_mode is None
    # and it matches the reference's decision there
    assert ref_choose_coded_linear(64, 32, 2, 19, 2).impl == "default"


def test_decision_kernel_mode_mapping():
    assert Decision("coded_linear", "default", None).kernel_mode is None
    assert Decision("coded_linear", "svd", "cuda").kernel_mode == "svd"
    assert Decision("coded_linear", "fused", "off").kernel_mode == "off"
    assert Decision("coded_linear", "fused", "cuda").kernel_mode == "cuda"


def test_decisions_are_memoized_until_invalidated(tmp_path):
    set_table_path(str(tmp_path / "nope.json"))
    a = choose_matvec(10826, 4096, 4, backend="cuda")
    assert choose_matvec(10826, 4096, 4, backend="cuda") is a
    assert choose_matvec(10826, 4096, 4, backend="cuda", macro_k=4) is not a
    _table(tmp_path, [_entry(op="coded_matvec", shape="10826x4096x4", impl="cuda")])
    b = choose_matvec(10826, 4096, 4, backend="cuda")
    assert b.source == "table" and b.measured_us == 900.0


def test_env_override_points_singleton(tmp_path, monkeypatch):
    p = tmp_path / "autotune.json"
    p.write_text(json.dumps({"version": 1, "hardware": {}, "entries": []}))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", str(p))
    assert default_table_path() == str(p)
    dispatch.invalidate()
    assert dispatch.get_table() is not None
    assert dispatch.get_table().entries == {}
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_TABLE")
    assert default_table_path() == COMMITTED


def test_context_vars():
    assert ctx.current_head_kernel_mode() is None
    with ctx.head_kernel_mode("auto"):
        assert ctx.current_head_kernel_mode() == "auto"
        with ctx.head_kernel_mode(None):  # None = no-op passthrough
            assert ctx.current_head_kernel_mode() == "auto"
    assert ctx.current_head_kernel_mode() is None
    assert ctx.current_macro_step_k() == 1
    with ctx.macro_step_k(16):
        assert ctx.current_macro_step_k() == 16
        with ctx.macro_step_k(None), ctx.macro_step_k(1):
            assert ctx.current_macro_step_k() == 16
    assert ctx.current_macro_step_k() == 1
    mesh = HeadMesh((CPU,) * 16, axis="blocks")
    assert ctx.current_coded_head_mesh() is None
    with ctx.coded_head_mesh(mesh):
        assert ctx.current_coded_head_mesh() == (mesh, "blocks")
        with ctx.coded_head_mesh(None):
            assert ctx.current_coded_head_mesh() == (mesh, "blocks")
    assert ctx.current_coded_head_mesh() is None


# --------------------------------------------------------------------------
# 'auto' == the explicit mode it resolves to, on every entry point
# --------------------------------------------------------------------------
@pytest.mark.parametrize("macro_k", [1, 4])
@pytest.mark.parametrize("shape", [(256, 128, 4), (1024, 256, 8), (100, 40, 1), (256, 128, 33)])
def test_auto_bit_identical_to_resolved_explicit(shape, macro_k):
    out, inner, b = shape
    cl, w, wc, x, m = _apply_setup(out=out, inner=inner, b=b)
    with ctx.macro_step_k(macro_k):
        d = choose_coded_linear(out, inner, b, 12, 4, backend="cpu", macro_k=macro_k)
        got = cl.apply(wc, x, m, kernel_mode="auto")
    want = cl.apply(wc, x, m, kernel_mode=d.kernel_mode)
    assert torch.equal(got, want)
    assert torch.equal(got, cl.apply(wc, x, m))  # on a CPU tensor: the plain version
    # the reference's 'auto' computes the same function
    from repro.core.coded_ops import CodedLinear as JaxCodedLinear

    ref = JaxCodedLinear(12, 4, out)
    jwc = ref.encode(jax.numpy.asarray(w))
    jy = np.asarray(ref.apply(jwc, jax.numpy.asarray(x.numpy()), jax.numpy.asarray(m.numpy()),
                              kernel_mode="auto"))
    np.testing.assert_allclose(got.numpy(), jy, rtol=1e-4, atol=1e-4 * np.abs(jy).max())


def test_ops_auto_equals_plain_on_cpu():
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    a, x = t(300, 70), t(70, 5)
    assert torch.equal(ops.coded_matvec(a, x, "auto"), ops.coded_matvec(a, x, "off"))
    wc, rec = t(16 * 9, 70), t(12, 16)
    assert torch.equal(ops.coded_matvec_decode(wc, x, rec, "auto"),
                       ops.coded_matvec_decode(wc, x, rec, "off"))
    g, a2 = t(16, 13), t(13, 1031)
    assert torch.equal(ops.gaussian_encode(g, a2, "auto"), ops.gaussian_encode(g, a2, "off"))
    lt = LTCode(40, seed=2).plan(60)
    a3 = t(40, 33)
    idx, cof = torch.from_numpy(lt.indices), torch.from_numpy(lt.coeffs)
    assert torch.equal(ops.lt_encode(a3, idx, cof, "auto"), ops.lt_encode(a3, idx, cof, "off"))
    for plan in (lt, GaussianCode(40, seed=1).plan(52)):
        assert torch.equal(ops.encode_rows(a3, plan, 40, plan.q, mode="auto"),
                           ops.encode_rows(a3, plan, 40, plan.q, mode=None))
    w = t(50, 24)
    assert torch.equal(ops.encode_blocks_device(w, 13, 3, "auto"),
                       ops.encode_blocks_device(w, 13, 3, None))
    mesh = HeadMesh((CPU,) * 16)
    mask = torch.ones(16)
    mask[[2, 9]] = 0.0
    wch = t(16 * 7, 24)
    xh = t(24, 3)
    assert torch.equal(ops.coded_head_matvec(wch, xh, mask, 14, 2, mesh=mesh, kernel_mode="auto"),
                       ops.coded_head_matvec(wch, xh, mask, 14, 2, mesh=mesh))
    assert torch.equal(ops.coded_head_matvec(wch, xh, mask, 14, 2, kernel_mode="auto"),
                       ops.coded_head_matvec(wch, xh, mask, 14, 2))
    assert ops.resolve_mode("auto", a) == "off"


# --------------------------------------------------------------------------
# the engine and the task form under 'auto'
# --------------------------------------------------------------------------
def _models(arch, parity=2):
    cfg = jax_config(arch, smoke=True).scaled(dtype="float32", coded=True, coded_parity=parity)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=True, coded_parity=parity)
    return cfg, jm, jp, build_model(tcfg), tp


def _drive(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p.copy(), max_new_tokens=max_new))
    return {r.uid: list(r.out_tokens) for r in eng.run()}


def _stragglers():
    lat = np.full(16, 1e-3)
    lat[[2, 7, 11]] = 5e-2
    return lat


def test_engine_auto_equals_default_and_reference_auto():
    """glm4-9b smoke, float32, three persistent stragglers on a parity
    budget of 2: the (14, 2) -> (13, 3) raise re-encodes through 'auto'.
    Tokens and parity events equal the port's default engine's and the
    reference engine's under head_kernel_mode='auto'."""
    cfg, jm, jp, tm, tp = _models("glm4-9b")
    prompts = [np.arange(4 + i) % cfg.vocab for i in range(3)]
    kw = dict(n_slots=2, s_max=32, latency_fn=_stragglers, parity_topup=1, topup_patience=2)
    auto = ServeEngine(tm, tp, parity_controller=ParityController(16, decay=0.5), device="cpu",
                       head_kernel_mode="auto", encode_mode="auto", **kw)
    default = ServeEngine(tm, tp, parity_controller=ParityController(16, decay=0.5),
                          device="cpu", **kw)
    from repro.core.adaptive import ParityController as JaxParityController

    ref = JaxServeEngine(jm, jp, parity_controller=JaxParityController(16, decay=0.5),
                         head_kernel_mode="auto", encode_mode="interpret", **kw)
    got = _drive(auto, Request, prompts, 6)
    assert got == _drive(default, Request, prompts, 6)
    assert got == _drive(ref, JaxRequest, prompts, 6)
    assert len(auto.parity_events) == 1 and auto.model.cfg.coded_parity == 3
    strip = lambda evs: [{k: v for k, v in e.items() if k != "encode_mode"} for e in evs]  # noqa: E731
    assert strip(auto.parity_events) == strip(default.parity_events) == strip(ref.parity_events)
    assert auto.parity_events[0]["encode_mode"] == "auto"


@pytest.mark.parametrize("k", [4, 16])
def test_engine_auto_fused_equals_scalar(k):
    """Fused blocks under 'auto' are the scalar steps bit for bit on the
    CPU, and the head resolved at macro_step_k(k) inside the blocks."""
    cfg, _, _, tm, tp = _models("phi3-mini-3.8b")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32) for _ in range(3)]
    mask = np.ones(16)
    mask[[4, 13]] = 0.0
    kw = dict(n_slots=3, s_max=48, mask_fn=lambda: mask, head_kernel_mode="auto", device="cpu")
    scalar = _drive(ServeEngine(tm, tp, **kw), Request, prompts, 20)
    dispatch.invalidate()
    fused_eng = ServeEngine(tm, tp, macro_steps=k, **kw)
    assert _drive(fused_eng, Request, prompts, 20) == scalar
    assert fused_eng.macro_blocks > 0
    ks = {key[-1] for key in dispatch._memo if key[0] == "coded_linear"}
    assert 1 in ks and max(ks) > 1 and max(ks) <= k   # prefills, then the blocks' K buckets
    assert ctx.current_macro_step_k() == 1


def test_head_context_supplies_the_mode_where_the_argument_is_none():
    from repro_torch.models.transformer import _last_logits

    cfg, _, _, tm, tp = _models("glm4-9b")
    hidden = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(0))
    want = _last_logits(tp, hidden, tm.cfg, None, None)
    with ctx.head_kernel_mode("auto"):
        assert torch.equal(_last_logits(tp, hidden, tm.cfg, None, None), want)
        with pytest.raises(ValueError, match="unknown kernel mode"):
            _last_logits(tp, hidden, tm.cfg, None, "triton")
    with ctx.head_kernel_mode("triton"):   # the context reaches the head
        with pytest.raises(ValueError, match="unknown kernel mode"):
            _last_logits(tp, hidden, tm.cfg, None, None)
        assert torch.equal(_last_logits(tp, hidden, tm.cfg, None, "off"), want)
    with ctx.coded_head_mesh(HeadMesh((CPU,) * 16)):
        assert torch.equal(_last_logits(tp, hidden, tm.cfg, None, None), want)


@pytest.mark.parametrize("code", ["lt", "gaussian"])
def test_task_auto_encode_equals_device_encode(code):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((400, 64)).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    _, workers = ec2_scenario(1)
    churn = adaptive.ChurnSchedule((adaptive.ChurnEvent(t=0.01, worker=0, kind="death"),
                                    adaptive.ChurnEvent(t=0.008, worker=1, kind="rate",
                                                        factor=5.0)))
    runs = []
    for mode in ("auto", "device"):
        em = ClusterEmulator(workers, time_scale=0.02, seed=9, device="cpu")
        spec = TaskSpec(code=code, adaptive=adaptive.ReallocationPolicy(), churn=churn,
                        encode_mode=mode)
        runs.append((em.run_task(a, x, spec), em.last_encode))
    (got, enc), (want, _) = runs
    assert enc is not None and enc["rows"] > 0   # all of Â went through 'auto'
    for name in got.PAYLOAD_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w, name
    assert got.arrival_order() == want.arrival_order()
    assert got.reallocations == want.reallocations


# --------------------------------------------------------------------------
# the autotuner's pure parts and the committed table
# --------------------------------------------------------------------------
@pytest.mark.parametrize("svd_us,want", [(1000.0, "fused"), (995.0, "fused"), (990.5, "fused"),
                                         (989.0, "svd"), (700.0, "svd"), (1200.0, "fused")])
def test_autotune_winner_keeps_the_default_within_the_tie(svd_us, want):
    """The default's candidate (first: fused) keeps the cell unless another
    is faster by more than TIE (1 %)."""
    cands = [{"impl": "fused", "us": 1000.0}, {"impl": "svd", "us": svd_us}]
    assert autotune.winner(cands)["impl"] == want


def test_autotune_cells_and_table_build(tmp_path):
    full = autotune.cells()
    ops_ = [op for op, _ in full]
    assert ops_.count("coded_linear") == 10 and ops_.count("coded_matvec") == 2
    assert ops_.count("gaussian_encode") == 6 and ops_.count("lt_encode") == 1
    heads = {(g["out"], g["inner"]) for op, g in full if op == "coded_linear"}
    assert (14 * 10826, 4096) in heads and (14 * 7168, 6144) in heads  # glm4-9b, dbrx-132b
    assert [op for op, _ in autotune.cells(quick=True)] == [
        "coded_linear", "coded_matvec", "gaussian_encode"]
    doc = _measured_doc()
    for e in doc["entries"]:
        assert e["backend"] == "cuda" and e["mode"] == "cuda" and e["source"] == "measured"
        assert e["params"] == {} and e["impl"] == e["candidates"][0]["impl"]
        assert all(c["model_error"] >= 1.0 for c in e["candidates"])
    assert doc["hardware"]["cuda"] == cost.H100_HOST.as_dict()
    with pytest.raises(ValueError, match="reference"):
        autotune.write_table(doc, autotune.REFERENCE_TABLE)


def test_committed_table_is_healthy():
    tab = DispatchTable.load(COMMITTED)
    assert tab is not None, "committed table missing, unparseable or of the wrong version"
    assert tab.entries, "committed table is empty"
    meta = tab.doc["meta"]
    assert "H100" in meta["card"] and meta["card"].rstrip().endswith("W"), meta["card"]
    assert meta["torch"] and meta["cuda"] and not meta["quick"]
    cells = {(op, autotune.shape_key(op, g)) for op, g in autotune.cells() if op != "lt_encode"}
    assert cells <= {(op, shape) for op, _, shape, _ in tab.entries}
    for key, e in tab.entries.items():
        where = f"{e['op']} {e['shape']} [{e['backend']}]"
        assert e["backend"] == "cuda" and e["source"] == "measured", where
        kernels = ("fused", "svd") if e["op"] == "coded_linear" else ("cuda",)
        assert e["impl"] in kernels and e["mode"] == "cuda", f"non-kernel winner at {where}"
        assert e["model_error"] <= cost.MODEL_ERROR_BOUND, \
            f"winner at {where} is {e['model_error']:.2f}x off the model"
        assert e["params"] == {} and all(c["params"] == {} for c in e["candidates"]), where
        assert e["impl"] == autotune.winner(e["candidates"])["impl"], where
        assert e["library_us"] > 0 and e["library_call"], where
        assert tab.lookup(*key, geometry=e["geometry"]) is e, where


def test_new_modules_import_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.kernels.cost, repro_torch.kernels.dispatch\n"
            "import repro_torch.kernels.autotune, repro_torch.sharding.ctx\n"
            "import repro_torch.kernels.ops, repro_torch.serve.engine\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
