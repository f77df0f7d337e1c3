"""The masked pseudo-inverse behind the SVD decode, on the CPU (no card).

``csrc/masked_pinv.cu`` builds rec = pinv(diag(m) B, rtol 1e-6) · diag(m)
for the coded head's generator B by a one-sided Jacobi SVD in float64.
Here:

  * its plain version (``kernels.ref.ref_masked_pinv``, ``torch.linalg.pinv``
    in float64) against numpy's float64 pinv of the reference's generator
    (``repro.core.coded_ops.block_mds_generator_np``) on every mask of at
    most P erasures and on masks of P + 1, at (10, 6), (14, 2) and (22, 2)
    (24 blocks, above ``MAX_LUT_BLOCKS``): within fp32 rounding (1e-6 of
    max|rec|), erased columns exactly 0;
  * the kernel's arithmetic emulated in float64 torch (its round-robin pair
    order, its orthogonality test, rotation, cutoff and formula) against the
    same oracle, each mask within nb n cond(A) eps of its own max|rec| (the
    worst (10, 6) pattern, cond 4.6e4, is off by 1.1e-12 of the batch's
    max|rec|);
  * the reference's fused engine against the port's (``macro_steps=4``) on
    a 16-block coded smoke head in the three cases the card's CUDA graphs
    now hold: a (10, 6) head, ``head_kernel_mode='svd'`` and a top-up that
    raises (11, 5) into (10, 6): greedy tokens and parity events equal, and
    the port's fused tokens equal its scalar ones.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""
import itertools
import math

import jax
import numpy as np
import pytest
import torch

from repro.core.coded_ops import block_mds_generator_np as ref_generator
from repro_torch.core import coded_ops
from repro_torch.core.decoding import MAX_LUT_BLOCKS, cacheable
from repro_torch.kernels import ops
from repro_torch.kernels.masked_pinv import (
    MAX_SWEEPS,
    masked_pinv_cuda,
    round_robin,
    smem_bytes,
)
from repro_torch.kernels.ref import ref_masked_pinv

GEOMETRIES = [(10, 6), (14, 2), (22, 2)]   # (n_data, n_parity); 16, 16 and 24 blocks
EPS = float(np.finfo(np.float64).eps)


def _masks(nb: int, n_parity: int, extra: int = 64, seed: int = 0) -> np.ndarray:
    """Every mask of at most n_parity erasures, then ``extra`` seeded masks
    of n_parity + 1 (one erasure too many: the least-norm pseudo-inverse)."""
    rows = []
    for e in range(n_parity + 1):
        for erased in itertools.combinations(range(nb), e):
            m = np.ones(nb, np.float32)
            m[list(erased)] = 0.0
            rows.append(m)
    rng = np.random.default_rng(seed)
    for _ in range(extra):
        m = np.ones(nb, np.float32)
        m[rng.choice(nb, n_parity + 1, replace=False)] = 0.0
        rows.append(m)
    return np.stack(rows)


def _oracle(masks: np.ndarray, gen: np.ndarray) -> np.ndarray:
    """numpy's float64 pinv of each masked generator, times the mask."""
    m = masks.astype(np.float64)
    return np.linalg.pinv(gen[None] * m[:, :, None], rtol=1e-6) * m[:, None, :]


def _jacobi(masks: torch.Tensor, gen: torch.Tensor):
    """csrc/masked_pinv.cu's arithmetic in float64 torch, every mask at once:
    (rec before its fp32 cast [M, n, nb], each mask's sweep count).  A mask
    whose sweep rotated nothing is left as it is; sweeping it again would
    rotate nothing either."""
    nb, n = gen.shape
    m = masks.to(torch.float64)
    a = (m[:, :, None] * gen[None]).transpose(1, 2).clone()   # [M, n, nb]: column j of A
    v = torch.eye(n, dtype=torch.float64).expand(len(m), n, n).clone()  # [M, n, n]: column j of V
    tiny = 1e-30 * (a * a).sum((1, 2))
    tol = nb * EPS
    rounds = round_robin(n)
    live = torch.ones(len(m), dtype=torch.bool)
    sweeps = torch.zeros(len(m), dtype=torch.int32)
    for _ in range(MAX_SWEEPS):
        if not live.any():
            break
        sweeps += live.to(torch.int32)
        rotated = torch.zeros(len(m), dtype=torch.bool)
        for pairs in rounds:
            for p, q in pairs:
                al = (a[:, p] * a[:, p]).sum(1)
                be = (a[:, q] * a[:, q]).sum(1)
                ga = (a[:, p] * a[:, q]).sum(1)
                turn = live & (al > tiny) & (be > tiny) & (ga.abs() > tol * al.sqrt() * be.sqrt())
                zeta = (be - al) / torch.where(turn, 2.0 * ga, torch.ones_like(ga))
                t = torch.copysign(torch.ones_like(zeta), zeta) / (zeta.abs()
                                                                   + (1.0 + zeta * zeta).sqrt())
                c = torch.where(turn, 1.0 / (1.0 + t * t).sqrt(), torch.ones_like(t))
                s = torch.where(turn, c * t, torch.zeros_like(t))
                for x in (a, v):
                    xp, xq = x[:, p].clone(), x[:, q].clone()
                    x[:, p] = c[:, None] * xp - s[:, None] * xq
                    x[:, q] = s[:, None] * xp + c[:, None] * xq
                rotated |= turn
        live &= rotated
    norm2 = (a * a).sum(2)                                      # [M, n]
    cut = 1e-6 * norm2.max(1).values.sqrt()
    w = torch.where(norm2.sqrt() > cut[:, None], 1.0 / norm2, torch.zeros_like(norm2))
    x = torch.einsum("mji,mj,mjr->mir", v, w, a)             # [M, n, nb]
    return x * m[:, None, :], sweeps


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def geometry(request):
    n_data, n_parity = request.param
    nb = n_data + n_parity
    gen = ref_generator(nb, n_data)
    masks = _masks(nb, n_parity)
    return n_data, n_parity, gen, masks, _oracle(masks, gen)


def test_geometries_are_the_ones_the_cache_refuses_or_the_svd_mode_takes():
    assert not cacheable(10, 6) and cacheable(14, 2) and 24 > MAX_LUT_BLOCKS
    assert sum(math.comb(16, e) for e in range(7)) == 14_893


def test_ref_masked_pinv_matches_numpy_over_every_mask(geometry):
    n_data, n_parity, gen, masks, want = geometry
    nb = n_data + n_parity
    port_gen = coded_ops.block_mds_generator_np(nb, n_data)
    np.testing.assert_array_equal(port_gen, gen)   # the port's copy, bit for bit
    got = ref_masked_pinv(torch.as_tensor(masks), torch.as_tensor(gen))
    assert got.dtype == torch.float32 and got.shape == (len(masks), n_data, nb)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    assert not got.numpy()[np.broadcast_to(masks[:, None, :] == 0, got.shape)].any()
    # one mask at a time gives the same matrix as the batch
    for i in (0, len(masks) // 2, len(masks) - 1):
        one = ref_masked_pinv(torch.as_tensor(masks[i]), torch.as_tensor(gen))
        np.testing.assert_allclose(one.numpy(), got[i].numpy(), rtol=0, atol=1e-7 * scale)


def _cond(masks: np.ndarray, gen: np.ndarray) -> np.ndarray:
    """Each masked generator's condition number over the singular values the
    rtol 1e-6 cutoff keeps."""
    sv = np.linalg.svd(gen[None] * masks[:, :, None].astype(np.float64), compute_uv=False)
    kept = np.where(sv > 1e-6 * sv[:, :1], sv, np.inf)
    return sv[:, 0] / kept.min(1)


def test_jacobi_emulation_matches_numpy_over_every_mask(geometry):
    """Each mask within nb n cond(A) eps of its own max|rec|: Jacobi and
    numpy's SVD are each good to cond(A) eps, times the rounding of sums
    over nb rows and n columns (the worst mask measured 20 cond(A) eps)."""
    n_data, n_parity, gen, masks, want = geometry
    nb = n_data + n_parity
    rec, sweeps = _jacobi(torch.as_tensor(masks), torch.as_tensor(gen))
    err = np.abs(rec.numpy() - want).reshape(len(masks), -1).max(1)
    scale = np.abs(want).reshape(len(masks), -1).max(1)
    tol = nb * n_data * EPS * _cond(masks, gen) * scale
    assert (err <= tol).all(), f"mask {int((err / tol).argmax())}: {(err / tol).max()} x its tol"
    erased = np.broadcast_to(masks[:, None, :] == 0, rec.shape)
    assert not rec.numpy()[erased].any()
    # every mask converged (a sweep rotated nothing) well inside the cap
    assert int(sweeps.max()) < MAX_SWEEPS and int(sweeps.min()) >= 1


@pytest.mark.parametrize("n", [1, 2, 3, 9, 10, 14, 22, 31, 32])
def test_round_robin_pairs_every_column_pair_once(n):
    rounds = round_robin(n)
    assert len(rounds) == n + (n & 1) - 1
    seen = []
    for pairs in rounds:
        cols = [c for pair in pairs for c in pair]
        assert len(cols) == len(set(cols))   # a round's pairs are disjoint
        assert all(p < q < n for p, q in pairs)
        seen += pairs
    assert sorted(seen) == list(itertools.combinations(range(n), 2))


def test_svd_recovery_on_cpu_is_the_plain_version_with_the_cached_generator():
    masks = _masks(16, 6, extra=4)[::997]
    gen64 = coded_ops._generator64(16, 10, torch.device("cpu"))
    assert gen64 is coded_ops._generator64(16, 10, torch.device("cpu"))
    assert gen64.dtype == torch.float64
    np.testing.assert_array_equal(gen64.numpy(), ref_generator(16, 10))
    for m in masks:
        got = coded_ops.svd_recovery(torch.as_tensor(m), 10, 6)
        want = ref_masked_pinv(torch.as_tensor(m), gen64)
        assert torch.equal(got, want)
        assert torch.equal(ops.masked_pinv(torch.as_tensor(m), gen64, mode="off"), want)


def test_kernel_wrapper_refuses_cpu_tensors_and_oversized_geometries():
    m, gen = torch.ones(16), torch.as_tensor(ref_generator(16, 10))
    with pytest.raises(ValueError, match="CUDA"):
        masked_pinv_cuda(m, gen)
    with pytest.raises(ValueError, match="CUDA"):
        ops.masked_pinv(m, gen, mode="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        coded_ops.svd_recovery(m, 10, 6, mode="cuda")
    assert smem_bytes(16, 10) == 8 * (160 + 100 + 10)      # 2.2 KB at (10, 6)
    assert smem_bytes(128, 120) > 227 * 1024              # refused on the card, by name


# ---- fused engines, the reference against the port ---------------------------------
N_BLOCKS = 16
STRAGGLERS = [1, 3, 5, 7, 9, 11]   # six persistent stragglers: more than (11, 5) absorbs


def _carried(parity):
    from repro.configs import get_config as jax_config
    from repro.models.registry import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import params_from_numpy

    kw = dict(dtype="float32", coded=True, coded_parity=parity)
    jcfg = jax_config("phi3-mini-3.8b", smoke=True).scaled(**kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tm = build_model(get_config("phi3-mini-3.8b", smoke=True).scaled(**kw))
    return jcfg, jm, jp, tm, tp


def _mask_fn(n_parity, seed):
    rng = np.random.default_rng(seed)

    def mask_fn():
        m = np.ones(N_BLOCKS)
        m[rng.choice(N_BLOCKS, rng.integers(0, n_parity + 1), replace=False)] = 0.0
        return m

    return mask_fn


def _latency_fn():
    def latency_fn():
        lat = np.full(N_BLOCKS, 1e-3)
        lat[STRAGGLERS] = 0.5
        return lat

    return latency_fn


CASES = {
    # (parity, engine keyword arguments, made fresh for each engine)
    "head_10_6": (6, lambda: dict(mask_fn=_mask_fn(6, 3))),
    "svd_mode": (2, lambda: dict(mask_fn=_mask_fn(2, 4), head_kernel_mode="svd")),
    "topup_into_10_6": (5, lambda: dict(latency_fn=_latency_fn(), parity_topup=1,
                                        topup_patience=2)),
}


def _run(pkg, carried, case, macro_steps):
    from repro.core.adaptive import ParityController as JaxParityController
    from repro.serve import Request as JaxRequest
    from repro.serve import ServeEngine as JaxServeEngine
    from repro_torch.core.adaptive import ParityController
    from repro_torch.serve import Request, ServeEngine

    jcfg, jm, jp, tm, tp = carried
    kw = CASES[case][1]()
    if "latency_fn" in kw:
        kw["parity_controller"] = (JaxParityController if pkg == "jax"
                                   else ParityController)(N_BLOCKS, decay=0.5)
    if pkg == "jax":
        eng = JaxServeEngine(jm, jp, n_slots=2, s_max=32, macro_steps=macro_steps, **kw)
        req = JaxRequest
    else:
        eng = ServeEngine(tm, tp, n_slots=2, s_max=32, macro_steps=macro_steps, device="cpu",
                          **kw)
        req = Request
    rng = np.random.default_rng(9)
    for i in range(4):
        eng.submit(req(uid=i, prompt=rng.integers(0, jcfg.vocab, 4 + i).astype(np.int32),
                       max_new_tokens=12))
    eng.run()
    return {"tokens": {r.uid: list(r.out_tokens) for r in eng.completed},
            "events": [{f: e[f] for f in ("step", "n_parity")} for e in eng.parity_events],
            "parity": eng.model.cfg.coded_parity, "blocks": eng.macro_blocks}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_engine_equals_reference(case):
    carried = _carried(CASES[case][0])
    ref = _run("jax", carried, case, 4)
    got = _run("torch", carried, case, 4)
    scalar = _run("torch", carried, case, 1)
    assert got["tokens"] == ref["tokens"] == scalar["tokens"]
    assert got["events"] == ref["events"] == scalar["events"]
    assert got["blocks"] == ref["blocks"] and got["blocks"] > 0
    assert all(len(t) == 12 for t in got["tokens"].values())
    if case == "topup_into_10_6":
        assert [e["n_parity"] for e in got["events"]] == [6] and got["parity"] == 6
    else:
        assert not got["events"]
