"""The port's mesh-sharded coded head, its local product and the rest of the
core's coded ops, against the JAX reference on the CPU.

The reference's own sharded head fails under the installed jax (its mesh
tests are known failures), so the port's sharded head is held to the
contracts those tests assert: the reference's single-device
``CodedLinear.apply`` and single-device engine.  The mesh here is sixteen
logical devices on one CPU, ``HeadMesh((cpu,) * 16)``, as the reference's
tests force sixteen host devices onto one CPU; every kernel runs its plain
version.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.adaptive import ParityController as JaxParityController
from repro.core.coded_ops import CodedLinear as JaxCodedLinear
from repro.core.coded_ops import bpcc_batched_matvec as jax_bpcc_batched_matvec
from repro.core.coded_ops import row_coded_matvec as jax_row_coded_matvec
from repro.core.decoding import ls_decode as jax_ls_decode
from repro.core.decoding import masked_pinv_decode as jax_masked_pinv_decode
from repro.core.decoding import peel_decode_jax
from repro.core.encoding import GaussianCode as RefGaussianCode
from repro.core.encoding import LTCode as RefLTCode
from repro.core.encoding import encode_matrix as ref_encode_matrix
from repro.kernels import coded_matvec as jax_coded_matvec
from repro.kernels import ref as jax_ref
from repro.models.registry import build_model as jax_build
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.core import (
    bpcc_batched_matvec,
    ls_decode,
    masked_pinv_decode,
    peel_decode_np,
    peel_decode_torch,
    row_coded_matvec,
)
from repro_torch.core.adaptive import ParityController
from repro_torch.core.coded_ops import encode_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_coded_matvec
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.sharding import (
    HeadMesh,
    serve_head_mesh,
    shard_coded_head,
    validate_coded_head_mesh,
)
from repro_torch.weights import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS = 16  # the serving head's block count (models.config.coded_blocks)
CPU = torch.device("cpu")


def _cpu_mesh(n=N_BLOCKS):
    return HeadMesh((CPU,) * n)


def _mesh_masks():
    """The reference mesh test's masks: none erased, then single and double
    erasures walking the blocks."""
    masks = [np.ones(N_BLOCKS, np.float32)]
    for i in range(0, N_BLOCKS, 5):
        m = np.ones(N_BLOCKS, np.float32)
        m[i] = 0.0
        masks.append(m)
        m2 = m.copy()
        m2[(i + 7) % N_BLOCKS] = 0.0
        masks.append(m2)
    return masks


# --------------------------------------------------------------------------
# the local product: coded_matvec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("r,m,b", [
    (64, 64, 1), (100, 70, 1), (256, 512, 4), (300, 1000, 8),
    (1, 4096, 1), (513, 129, 3),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_coded_matvec_matches_reference(r, m, b, dtype):
    """The plain version against the reference's Pallas kernel (interpret
    mode) and its jnp oracle, over the reference's sweep.  Tolerance: the
    reference's own, rtol 2e-3 and atol 2e-3 * max(1, max|want|)."""
    rng = np.random.default_rng(r * 1000 + m)
    a = rng.standard_normal((r, m)).astype(dtype)
    x = (rng.standard_normal((m, b)) if b > 1 else rng.standard_normal(m)).astype(dtype)
    got = ops.coded_matvec(torch.as_tensor(a), torch.as_tensor(x), mode="off")
    assert got.dtype == torch.float32 and tuple(got.shape) == ((r, b) if b > 1 else (r,))
    # mode None on a CPU tensor is the plain version too
    assert torch.equal(ops.coded_matvec(torch.as_tensor(a), torch.as_tensor(x)), got)
    got = got.numpy()
    for want in (np.asarray(jax_coded_matvec(jnp.asarray(a), jnp.asarray(x))),
                 np.asarray(jax_ref.ref_coded_matvec(jnp.asarray(a), jnp.asarray(x)))):
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=2e-3 * max(1, np.abs(want).max()))


def test_coded_matvec_kernel_mode_on_cpu_raises():
    a, x = torch.zeros(4, 8), torch.zeros(8, 2)
    for mode in ("cuda", "compile"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.coded_matvec(a, x, mode=mode)
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda

    with pytest.raises(ValueError, match="CUDA"):
        coded_matvec_cuda(a, x)


# --------------------------------------------------------------------------
# the sharded head primitive
# --------------------------------------------------------------------------
def test_coded_head_matvec_mesh_matches_single_device():
    """Mesh head vs the reference's single-device CodedLinear head and the
    exact product (rel 1e-3), across the reference mesh test's erasure
    patterns.

    Against the reference: within 1e-4 * max|y|, the fused head's kernel
    bound.  The reference's mesh test asserts atol 1e-5, but between two
    runs of one framework.  Across frameworks the coded products differ by
    an ulp (2.9e-6 at max|y_coded| 17.6 here), and the decode multiplies
    that by the recovery matrix's row sum: 218 when blocks 5 and 12 are
    erased, giving 1.45e-4.  Against the port's own single-device head it
    is bit-equal: on the CPU both run the same per-row fp32 products (a
    block is a row slice of the same matmul) and the same recovery matrix
    from the DecoderCache."""
    n_data, n_parity = N_BLOCKS - 2, 2
    rng = np.random.default_rng(0)
    w = rng.standard_normal((220, 32)).astype(np.float32)
    cl = JaxCodedLinear(n_data=n_data, n_parity=n_parity, out_features=220)
    wc_ref = cl.encode(jnp.asarray(w))
    x = rng.standard_normal((32, 3)).astype(np.float32)
    wc = encode_blocks(torch.as_tensor(w), n_data, n_parity)
    np.testing.assert_allclose(wc.numpy(), np.asarray(wc_ref), rtol=0, atol=1e-6)
    mesh = _cpu_mesh()
    placed = shard_coded_head(wc, mesh)
    br = wc.shape[0] // N_BLOCKS
    assert all(blk.data_ptr() == wc[i * br:].data_ptr() for i, blk in enumerate(placed))
    exact = w @ x
    for m in _mesh_masks():
        ref = np.asarray(cl.apply(wc_ref, jnp.asarray(x), jnp.asarray(m)))[:220]
        mt = torch.as_tensor(m)
        got = ops.coded_head_matvec(wc, torch.as_tensor(x), mt, n_data, n_parity, mesh=mesh)
        assert got.shape == (16 * n_data, 3)
        np.testing.assert_allclose(got[:220].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
        assert np.abs(got[:220].numpy() - exact).max() / np.abs(exact).max() < 1e-3
        single = ops.coded_head_matvec(wc, torch.as_tensor(x), mt, n_data, n_parity)
        assert torch.equal(got, single)
        # the placed blocks give the same result as the whole weight
        assert torch.equal(ops.coded_head_matvec(placed, torch.as_tensor(x), mt, n_data,
                                                 n_parity, mesh=mesh), got)


def test_validate_coded_head_mesh_rejects_wrong_geometry():
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="one block per"):
        validate_coded_head_mesh(mesh, N_BLOCKS, "model")
    with pytest.raises(ValueError, match="no 'data' axis"):
        validate_coded_head_mesh(mesh, 2, "data")
    validate_coded_head_mesh(_cpu_mesh(), N_BLOCKS, "model")
    # the head path validates too
    wc = torch.zeros(16 * 3, 4)
    with pytest.raises(ValueError, match="one block per"):
        ops.coded_head_matvec(wc, torch.zeros(4, 1), torch.ones(16), 14, 2, mesh=mesh)


def test_head_mesh_refuses_absent_cards():
    """No fallback: a mesh naming a card this machine lacks raises, and
    serve_head_mesh wants one card per block."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA device"):
        HeadMesh((torch.device("cuda", n),) * 2)
    if n < N_BLOCKS:
        with pytest.raises(ValueError, match="needs 16 devices"):
            serve_head_mesh(N_BLOCKS)
    with pytest.raises(ValueError, match="at least one"):
        HeadMesh(())
    with pytest.raises(ValueError, match="row blocks"):
        shard_coded_head(torch.zeros(17, 4), _cpu_mesh())


# --------------------------------------------------------------------------
# the engine on a mesh
# --------------------------------------------------------------------------
def _models(arch, coded=True, parity=2):
    cfg = jax_config(arch, smoke=True).scaled(dtype="float32", coded=coded,
                                              coded_parity=parity)
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = get_config(arch, smoke=True).scaled(dtype="float32", coded=coded,
                                               coded_parity=parity)
    return cfg, jm, jp, build_model(tcfg), tp


def _drive(eng, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(request_cls(uid=i, prompt=p.copy(), max_new_tokens=max_new))
    return {r.uid: list(r.out_tokens) for r in eng.run()}


def test_engine_mesh_tokens_equal_single_device():
    """The reference mesh test's drive (phi3-mini smoke, parity 2, masks
    alternating between none and blocks 3 and 9 erased), float32: the mesh
    engine's tokens equal the reference's single-device engine's and the
    port's single-device engine's."""
    cfg, jm, jp, tm, tp = _models("phi3-mini-3.8b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32) for _ in range(4)]
    masks = [np.ones(N_BLOCKS), np.ones(N_BLOCKS)]
    masks[1][[3, 9]] = 0.0

    def mask_fn_factory():
        state = {"n": 0}

        def mask_fn():
            state["n"] += 1
            return masks[state["n"] % 2]

        return mask_fn

    ref = _drive(JaxServeEngine(jm, jp, n_slots=2, s_max=32, mask_fn=mask_fn_factory()),
                 JaxRequest, prompts, 8)
    single = ServeEngine(tm, tp, n_slots=2, s_max=32, mask_fn=mask_fn_factory(), device="cpu")
    mesh_eng = ServeEngine(tm, tp, n_slots=2, s_max=32, mask_fn=mask_fn_factory(),
                           mesh=_cpu_mesh(), device="cpu")
    assert isinstance(mesh_eng.params["lm_head_coded"], tuple)
    assert len(mesh_eng.params["lm_head_coded"]) == N_BLOCKS
    assert isinstance(tp["lm_head_coded"], torch.Tensor)  # the caller's params are kept
    got = _drive(mesh_eng, Request, prompts, 8)
    assert got == ref
    assert _drive(single, Request, prompts, 8) == ref
    assert mesh_eng.sync_count == single.sync_count


def test_engine_mesh_parity_raise_replaces_head_on_mesh():
    """Three persistent stragglers on a budget of 2: the (14, 2) -> (13, 3)
    re-encode is placed again on the mesh, and the tokens stay those of the
    reference's and the port's single-device engines."""
    cfg, jm, jp, tm, tp = _models("glm4-9b")

    def latency_fn():
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    prompts = [np.arange(4 + i) % cfg.vocab for i in range(3)]
    kw = dict(n_slots=2, s_max=32, latency_fn=latency_fn, parity_topup=1,
              topup_patience=2, encode_mode="interpret")
    jeng = JaxServeEngine(jm, jp, parity_controller=JaxParityController(16, decay=0.5), **kw)
    single = ServeEngine(tm, tp, parity_controller=ParityController(16, decay=0.5),
                         device="cpu", **kw)
    mesh = _cpu_mesh()
    meng = ServeEngine(tm, tp, parity_controller=ParityController(16, decay=0.5),
                       mesh=mesh, device="cpu", **kw)
    ref = _drive(jeng, JaxRequest, prompts, 6)
    assert _drive(single, Request, prompts, 6) == ref
    assert _drive(meng, Request, prompts, 6) == ref
    assert meng.parity_events == jeng.parity_events == single.parity_events
    assert len(meng.parity_events) == 1 and meng.model.cfg.coded_parity == 3
    blocks = meng.params["lm_head_coded"]
    assert isinstance(blocks, tuple) and len(blocks) == N_BLOCKS
    assert all(tuple(b.shape) == (40, cfg.d_model) for b in blocks)  # ceil(512 / 13) rows
    assert torch.equal(torch.cat(blocks), single.params["lm_head_coded"])


def test_engine_mesh_refuses_uncoded_config_and_wrong_mesh():
    _, _, _, tm, tp = _models("phi3-mini-3.8b", coded=False)
    with pytest.raises(ValueError, match="coded model config"):
        ServeEngine(tm, tp, n_slots=1, s_max=32, mesh=_cpu_mesh(), device="cpu")
    _, _, _, tm, tp = _models("phi3-mini-3.8b")
    with pytest.raises(ValueError, match="one block per"):
        ServeEngine(tm, tp, n_slots=1, s_max=32, mesh=_cpu_mesh(8), device="cpu")
    with pytest.raises(ValueError, match="no 'data' axis"):
        ServeEngine(tm, tp, n_slots=1, s_max=32, mesh=_cpu_mesh(), head_axis="data",
                    device="cpu")


# --------------------------------------------------------------------------
# the rest of the coded ops and decoders
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b", [None, 3])
def test_bpcc_batched_matvec_matches_reference(b):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((20, 6)).astype(np.float32)
    x = rng.standard_normal(6 if b is None else (6, b)).astype(np.float32)
    arrived = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    y, rows = bpcc_batched_matvec(torch.as_tensor(a), torch.as_tensor(x), 5,
                                  torch.as_tensor(arrived))
    y_ref, rows_ref = jax_bpcc_batched_matvec(jnp.asarray(a), jnp.asarray(x), 5,
                                              jnp.asarray(arrived))
    assert float(rows) == float(rows_ref) == 12.0
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0, atol=1e-5)
    assert not y[4:8].any() and not y[16:20].any()  # batches that never arrived
    with pytest.raises(ValueError, match="not divisible"):
        bpcc_batched_matvec(torch.as_tensor(a), torch.as_tensor(x), 3,
                            torch.ones(3))


@pytest.mark.parametrize("one_d", [True, False])
def test_row_coded_matvec_matches_reference(one_d):
    """The reference test's case (30 rows, 44 coded, 10 erased).  Both solve
    the same fp32 normal equations: atol 1e-4 between the two, and the
    reference's 5e-2 to the exact product."""
    r = 30
    rng = np.random.default_rng(3)
    a = rng.standard_normal((r, 11)).astype(np.float32)
    plan = RefGaussianCode(r=r, seed=4).plan(44)
    g = plan.dense_generator().astype(np.float32)
    a_hat = (plan.dense_generator() @ a).astype(np.float32)
    x = rng.standard_normal(11 if one_d else (11, 2)).astype(np.float32)
    mask = np.ones(44, np.float32)
    mask[rng.permutation(44)[:10]] = 0.0
    got = row_coded_matvec(torch.as_tensor(a_hat), torch.as_tensor(x), torch.as_tensor(g),
                           torch.as_tensor(mask)).numpy()
    want = np.asarray(jax_row_coded_matvec(jnp.asarray(a_hat), jnp.asarray(x),
                                           jnp.asarray(g), jnp.asarray(mask)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.allclose(got, a @ x, atol=5e-2)


@pytest.mark.parametrize("r,q,seed", [(24, 40, 5), (24, 30, 6), (60, 90, 1)])
def test_peel_decode_torch_matches_reference(r, q, seed):
    """The fixed-shape peeling loop against the reference's
    ``peel_decode_jax`` (same pivots, so the same known set; values within
    1e-4) and against the numpy peeler where it decodes."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((r, 3)).astype(np.float32)
    plan = RefLTCode(r=r, seed=seed).plan(q)
    coded = ref_encode_matrix(a, plan)
    g = plan.dense_generator()
    y, known = peel_decode_torch(torch.as_tensor(coded), torch.as_tensor(g), r)
    y_jax, known_jax = peel_decode_jax(jnp.asarray(coded), jnp.asarray(g), r)
    assert known.numpy().tolist() == np.asarray(known_jax).tolist()
    assert y.dtype == torch.float32 and y.shape == (r, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=0, atol=1e-4)
    y_np, ok, _ = peel_decode_np(coded, plan.indices, plan.coeffs, r)
    if ok:
        assert bool(known.all())
        assert np.allclose(y.numpy(), y_np, atol=1e-4)


def test_ls_decode_matches_reference():
    """The reference's case: 36 of 48 Gaussian rows.  The port and the
    reference solve the same ridge normal equations in fp32: atol 1e-3
    between them, and the reference's 2e-2 to A."""
    r, m = 32, 9
    rng = np.random.default_rng(6)
    a = rng.standard_normal((r, m)).astype(np.float32)
    plan = RefGaussianCode(r=r, seed=7).plan(48)
    coded = ref_encode_matrix(a, plan)
    g = plan.dense_generator().astype(np.float32)
    keep = rng.permutation(48)[:r + 4]
    got = ls_decode(torch.as_tensor(g[keep]), torch.as_tensor(coded[keep])).numpy()
    want = np.asarray(jax_ls_decode(jnp.asarray(g[keep]), jnp.asarray(coded[keep])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.allclose(got, a, atol=2e-2)


def test_masked_pinv_decode_matches_reference():
    """The reference's case: 8 of 30 rows erased and filled with 1e6
    garbage, which must not leak.  atol 1e-3 between the packages, the
    reference's 5e-2 to A."""
    r = 20
    rng = np.random.default_rng(8)
    a = rng.standard_normal((r, 4)).astype(np.float32)
    plan = RefGaussianCode(r=r, seed=9).plan(30)
    coded = ref_encode_matrix(a, plan)
    g = plan.dense_generator().astype(np.float32)
    mask = np.ones(30, np.float32)
    mask[rng.permutation(30)[:8]] = 0.0
    garbage = coded.copy()
    garbage[mask == 0] = 1e6
    got = masked_pinv_decode(torch.as_tensor(g), torch.as_tensor(garbage),
                             torch.as_tensor(mask)).numpy()
    want = np.asarray(jax_masked_pinv_decode(jnp.asarray(g), jnp.asarray(garbage),
                                             jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.allclose(got, a, atol=5e-2)


def test_ref_coded_matvec_is_the_plain_product():
    a = torch.arange(12, dtype=torch.float16).reshape(3, 4)
    x = torch.ones(4, dtype=torch.float16)
    assert torch.equal(ref_coded_matvec(a, x), a.float() @ x.float())


def test_mesh_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.sharding, repro_torch.kernels.coded_matvec\n"
        "import repro_torch.core, repro_torch.core.coded_ops\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
