"""The port's MoE (``repro_torch.models.moe``) against the JAX reference's.

Same params (the reference's ``init_moe``, carried over through numpy) and
the same seeded inputs into both ``moe_apply``s, float32: outputs and the
aux loss within 1e-5 of max|reference|, routing ids equal to the
reference's ``lax.top_k``.  A routing id that differs is reported with its
top-k margin and fails unless that margin is under 1e-6 (a tie the two
packages may break on one ulp).  Covered: top-k 1, 2 and 4; capacity drops;
``dispatch_groups`` 1 and 2 and the fallback to one group; the shared
expert; swiglu, relu2 and gelu.  The reference's capacity and dense-sum
tests (``tests/test_models.py``) are mirrored on the port, and
``moe_apply_loop`` (token by token, the check the card runs) is held to
``moe_apply``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_apply as jax_moe_apply
from repro_torch.models.moe import init_moe, moe_apply, moe_apply_loop, route
from repro_torch.weights import params_from_numpy

TOL = 1e-5
TIE_MARGIN = 1e-6


def _pair(d, f, e, kind, shared, seed=0):
    jp = jax_init_moe(jax.random.key(seed), d, f, e, kind, shared, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _check_ids(tp, x, top_k):
    """Port routing ids against ``lax.top_k`` on the reference's probs."""
    xf = x.reshape(-1, x.shape[-1])
    want_probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(tp["router"].numpy()), axis=-1)
    _, want = jax.lax.top_k(want_probs, top_k)
    r = route(tp, torch.as_tensor(xf), top_k=top_k, capacity_factor=1.0)
    got, want = r.ids.numpy(), np.asarray(want)
    probs = np.sort(np.asarray(want_probs), axis=-1)[:, ::-1]
    margin = (probs[:, top_k - 1] - probs[:, top_k]) if top_k < probs.shape[1] else None
    flips = np.flatnonzero((got != want).any(-1))
    for t in flips:
        m = None if margin is None else float(margin[t])
        print(f"routing flip at token {t}: port {got[t]}, reference {want[t]}, margin {m}")
        assert m is not None and m < TIE_MARGIN, f"token {t}: ids differ at margin {m}"
    return len(flips)


def _run(jp, tp, x, **kw):
    jy, jaux = jax_moe_apply(jp, jnp.asarray(x), **kw)
    ty, taux = moe_apply(tp, torch.as_tensor(x), **kw)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=TOL * np.abs(jy).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)
    return ty, jy


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_matches_reference(top_k, groups, cf):
    """cf 0.5 drops assignments at capacity; 1.25 is the configs' default."""
    jp, tp = _pair(16, 24, 6, "swiglu", False)
    x = np.random.default_rng(top_k + 10 * groups).standard_normal((2, 12, 16)).astype(np.float32)
    kw = dict(top_k=top_k, capacity_factor=cf, kind="swiglu", dispatch_groups=groups)
    _run(jp, tp, x, **kw)
    assert _check_ids(tp, x, top_k) == 0
    r = route(tp, torch.as_tensor(x.reshape(-1, 16)), top_k=top_k, capacity_factor=cf,
              dispatch_groups=groups)
    assert r.groups == groups
    if cf < 1:
        assert not bool(r.keep.all())  # some assignments were dropped


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_kinds_and_shared_expert_match_reference(kind, shared):
    jp, tp = _pair(16, 24, 4, kind, shared, seed=1)
    assert ("w_gate" in tp) == (kind == "swiglu") and ("shared" in tp) == shared
    x = np.random.default_rng(3).standard_normal((1, 10, 16)).astype(np.float32)
    _run(jp, tp, x, top_k=2, capacity_factor=1.0, kind=kind)


def test_dispatch_groups_fall_back_to_one_group():
    """T·k not divisible by G: one group, as the reference's ``g_``."""
    jp, tp = _pair(8, 16, 4, "swiglu", False, seed=2)
    x = np.random.default_rng(4).standard_normal((1, 5, 8)).astype(np.float32)
    _run(jp, tp, x, top_k=1, capacity_factor=1.0, kind="swiglu", dispatch_groups=2)
    r = route(tp, torch.as_tensor(x[0]), top_k=1, capacity_factor=1.0, dispatch_groups=2)
    assert r.groups == 1


def test_capacity_rounds_as_the_reference():
    """cap = max(1, ceil(int(cf·k·T) / (E·G))), the int first."""
    tp = _pair(8, 16, 4, "swiglu", False)[1]
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((7, 8)).astype(np.float32))
    for cf, k, g, want in ((1.25, 2, 1, 5), (0.3, 1, 1, 1), (1.0, 2, 2, 2), (0.05, 1, 1, 1)):
        # int(1.25·2·7) = 17 -> ceil(17 / 4) = 5; int(2.1) = 2 -> 1; 14 / 8 -> 2
        assert route(tp, x, top_k=k, capacity_factor=cf, dispatch_groups=g).cap == want


def test_routing_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same prob: ``lax.top_k`` picks
    the lowest ids, and so must the port."""
    jp, tp = _pair(8, 16, 6, "swiglu", False, seed=3)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"].zero_()
    x = np.random.default_rng(6).standard_normal((1, 4, 8)).astype(np.float32)
    r = route(tp, torch.as_tensor(x[0]), top_k=3, capacity_factor=4.0)
    assert r.ids.tolist() == [[0, 1, 2]] * 4
    _run(jp, tp, x, top_k=3, capacity_factor=4.0, kind="swiglu")


def test_moe_capacity_drops_tokens():
    """Mirror of the reference's test: with tiny capacity, overflow tokens
    produce zero expert output."""
    gen = torch.Generator().manual_seed(0)
    p = init_moe(gen, 8, 16, 4, "swiglu", False, torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 64, 8)).astype(np.float32))
    y_small, _ = moe_apply(p, x, top_k=1, capacity_factor=0.05, kind="swiglu")
    y_big, _ = moe_apply(p, x, top_k=1, capacity_factor=8.0, kind="swiglu")
    assert float((y_small.abs().sum(-1) == 0).float().mean()) > 0.5
    assert float((y_big.abs().sum(-1) == 0).float().mean()) < 0.1


def test_moe_matches_dense_expert_sum():
    """Mirror of the reference's test: full capacity, top_k = E, the MoE
    output is the gate-weighted sum of every expert."""
    gen = torch.Generator().manual_seed(1)
    d, f, e, t = 4, 8, 2, 6
    p = init_moe(gen, d, f, e, "swiglu", False, torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1, t, d)).astype(np.float32))
    y, _ = moe_apply(p, x, top_k=e, capacity_factor=float(e * 2), kind="swiglu")
    xf = x.reshape(t, d)
    gates = torch.softmax(xf @ p["router"], -1)
    want = sum(gates[:, j:j + 1] * ((torch.nn.functional.silu(xf @ p["w_gate"][j])
                                     * (xf @ p["w_up"][j])) @ p["w_down"][j])
               for j in range(e))
    np.testing.assert_allclose(y.reshape(t, d).numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_apply_loop_matches_moe_apply(shared):
    """The token-by-token check equals the dispatched path (float32), drops
    included."""
    gen = torch.Generator().manual_seed(4)
    p = init_moe(gen, 16, 24, 4, "swiglu", shared, torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((2, 9, 16)).astype(np.float32))
    kw = dict(top_k=2, capacity_factor=0.75, kind="swiglu", dispatch_groups=2)
    y, _ = moe_apply(p, x, **kw)
    loop = moe_apply_loop(p, x, **kw)
    assert not bool(route(p, x.reshape(-1, 16), top_k=2, capacity_factor=0.75,
                          dispatch_groups=2).keep.all())
    np.testing.assert_allclose(loop.numpy(), y.numpy(), rtol=0, atol=TOL * float(y.abs().max()))
