"""The port's SSD (Mamba-2 chunked scan) against the JAX reference, on the CPU.

The same numpy inputs go through the reference and the port:

  * ``kernels.ref.ref_ssd_chunk`` / ``ref_ssd_combine`` against the
    reference's plain versions (``repro.kernels.ref``);
  * ``kernels.ops.ssd_forward`` (mode None: the plain versions on a CPU
    tensor) against the reference's ``ssd_forward`` with its Pallas kernels
    in interpret mode (its default, as ``tests/test_kernels.py`` runs it);
  * ``models.ssm.ssd_chunked`` (the port's einsum oracle) against the naive
    recurrence and across chunk sizes, as ``tests/test_models.py`` does.

Tolerances: float32 inputs at the reference's own rtol 1e-4, atol 1e-5
(``tests/test_kernels.py``), summed in another order.  bfloat16 inputs are
cast to fp32 first in both packages, so the fp32 sums see the same values;
their outputs are held to the same bound, and ``ssd_forward``'s y — cast
back to bf16 — within one bf16 step (2^-7 relative) besides.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ops import ssd_forward
from repro.models.ssm import ssd_chunked as ssd_chunked_ref
from repro_torch.kernels import ops, ref
from repro_torch.models.ssm import ssd_chunked, ssd_decode_step

# the reference's functions, jitted whole (the same computation, traced once
# per shape rather than op by op)
jax_ssd_forward = jax.jit(ssd_forward, static_argnames=("chunk", "mode"))
jax_ssd_chunked = jax.jit(ssd_chunked_ref, static_argnames=("chunk",))
jax_ref_ssd_chunk = jax.jit(jax_ref.ref_ssd_chunk)
jax_ref_ssd_combine = jax.jit(jax_ref.ref_ssd_combine)

# (B, S, H, P, G, N, Q): tests/test_kernels.py's sweep
SHAPES = [(2, 64, 4, 8, 2, 16, 16), (1, 32, 2, 16, 1, 8, 8), (2, 128, 8, 4, 4, 4, 32)]
RTOL, ATOL = 1e-4, 1e-5
BF16_STEP = 2.0 ** -7  # the widest relative spacing of bf16 values


def _inputs(seed, b, s, h, p, g, n, da_scale=0.3):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, s, h, p)) * 0.1).astype(np.float32),
        (-np.abs(rng.standard_normal((b, s, h))) * da_scale).astype(np.float32),
        (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32),
        (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32),
    )


def _as(arrs, dtype):
    """numpy fp32 -> (jax arrays, torch tensors), x, b and c in ``dtype``
    (da stays fp32, as the model makes it)."""
    x, da, b, c = arrs
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(x, jdt), jnp.asarray(da), jnp.asarray(b, jdt), jnp.asarray(c, jdt)]
    tx = [torch.as_tensor(x).to(tdt), torch.as_tensor(da), torch.as_tensor(b).to(tdt),
          torch.as_tensor(c).to(tdt)]
    return jx, tx


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _cells(arrs, q):
    """[B,S,H,*] model inputs -> the [B*H*nc, Q, F] cells the kernels take
    (G = H groups, so no head expansion)."""
    x, da, b, c = arrs
    bsz, s, h, p = x.shape
    nc = s // q

    def cells(t):
        f = t.shape[-1]
        return t.reshape(bsz, nc, q, h, f).transpose(0, 3, 1, 2, 4).reshape(-1, q, f)

    dac = da.reshape(bsz, nc, q, h).transpose(0, 3, 1, 2).reshape(-1, q)
    return cells(x), dac, cells(b), cells(c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,q", SHAPES)
def test_ref_ssd_chunk_and_combine_match_reference(b, s, h, p, g, n, q, dtype):
    x, da, bm, cm = _cells(_inputs(s, b, s, h, p, h, n), q)
    jx, tx = _as((x, da, bm, cm), dtype)
    want = jax_ref_ssd_chunk(*jx)
    got = ref.ref_ssd_chunk(*tx)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32 and tuple(g_.shape) == w_.shape
        _close(g_, w_)
    st_in = np.random.default_rng(1).standard_normal(got[1].shape).astype(np.float32)
    _close(ref.ref_ssd_combine(tx[3], got[3], torch.as_tensor(st_in)),
           jax_ref_ssd_combine(jx[3], want[3], jnp.asarray(st_in)))


def test_ref_ssd_chunk_selects_before_the_overflowing_exp():
    """|da| large enough that exp(cum_i - cum_j) above the diagonal is inf:
    the select keeps every output finite."""
    x, da, bm, cm = _cells(_inputs(5, 1, 64, 2, 8, 2, 16, da_scale=80.0), 64)
    got = ref.ref_ssd_chunk(*(torch.as_tensor(t) for t in (x, da, bm, cm)))
    with np.errstate(over="ignore"):
        assert np.exp(-da.sum(-1)).max() == np.inf   # the upper triangle overflows
    for t in got:
        assert torch.isfinite(t).all()
    for g_, w_ in zip(got, jax_ref_ssd_chunk(*(jnp.asarray(t) for t in (x, da, bm, cm)))):
        _close(g_, w_, atol=ATOL * max(1.0, float(np.abs(np.asarray(w_)).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,q", SHAPES)
def test_ssd_forward_matches_reference(b, s, h, p, g, n, q, dtype):
    jx, tx = _as(_inputs(s, b, s, h, p, g, n), dtype)
    y_j, f_j = jax_ssd_forward(*jx, chunk=q)
    y_t, f_t = ops.ssd_forward(*tx, chunk=q)
    assert y_t.dtype == getattr(torch, dtype) and f_t.dtype == torch.float32
    _close(f_t, f_j)
    if dtype == "float32":
        _close(y_t, y_j)
    else:  # y rounds to bf16 at the end: at most one bf16 step apart
        scale = float(np.abs(np.asarray(y_j, np.float32)).max())
        _close(y_t, y_j, rtol=BF16_STEP, atol=ATOL * scale)
    # and the port's own einsum oracle, in fp32
    if dtype == "float32":
        y_o, f_o = ssd_chunked(*tx, chunk=q)
        _close(y_t, y_o.numpy())
        _close(f_t, f_o.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_forward_with_initial_state_matches_reference(dtype):
    b, s, h, p, g, n = 1, 16, 2, 4, 1, 8
    arrs = _inputs(9, b, s, h, p, g, n)
    h0 = (np.random.default_rng(9).standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    jx, tx = _as(arrs, dtype)
    y_j, f_j = jax_ssd_forward(*jx, chunk=8, h0=jnp.asarray(h0))
    y_t, f_t = ops.ssd_forward(*tx, chunk=8, h0=torch.as_tensor(h0))
    _close(f_t, f_j)
    if dtype == "bfloat16":  # y rounds to bf16 at the end
        scale = float(np.abs(np.asarray(y_j, np.float32)).max())
        _close(y_t, y_j, rtol=BF16_STEP, atol=ATOL * scale)
        return
    _close(y_t, y_j)
    y_o, f_o = ssd_chunked(*tx, chunk=8, h0=torch.as_tensor(h0))
    _close(y_t, y_o.numpy())
    _close(f_t, f_o.numpy())


def test_ssd_forward_raises_on_a_ragged_sequence_as_the_reference():
    jx, tx = _as(_inputs(3, 1, 20, 2, 4, 1, 8), "float32")
    with pytest.raises(ValueError, match="must divide chunk"):
        jax_ssd_forward(*jx, chunk=8)
    with pytest.raises(ValueError, match="must divide chunk"):
        ops.ssd_forward(*tx, chunk=8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ssd_forward(*tx, chunk=4, mode="cuda")


def test_ssd_chunked_matches_naive_recurrence():
    """SSD chunked == step-by-step recurrence (state-space duality)."""
    b, s, h, p, g, n = 2, 24, 4, 8, 2, 16
    _, tx = _as(_inputs(0, b, s, h, p, g, n), "float32")
    x, da, bm, cm = tx
    y_chunk, final = ssd_chunked(x, da, bm, cm, chunk=8)
    y_fwd, f_fwd = ops.ssd_forward(x, da, bm, cm, chunk=8)
    state = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        y_t, state = ssd_decode_step(state, x[:, t], da[:, t], bm[:, t], cm[:, t])
        ys.append(y_t)
    y_naive = torch.stack(ys, dim=1).numpy()
    for y_, f_ in ((y_chunk, final), (y_fwd, f_fwd)):
        np.testing.assert_allclose(y_.numpy(), y_naive, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f_.numpy(), state.numpy(), rtol=1e-4, atol=1e-4)
    # and the reference's oracle on the same inputs
    jx, _ = _as(_inputs(0, b, s, h, p, g, n), "float32")
    y_j, f_j = jax_ssd_chunked(*jx, chunk=8)
    _close(y_chunk, y_j)
    _close(final, f_j)


def test_ssd_chunk_padding():
    """Non-multiple sequence lengths pad without corrupting the state."""
    _, tx = _as(_inputs(1, 1, 11, 2, 4, 1, 8), "float32")
    y4, f4 = ssd_chunked(*tx, chunk=4)
    y_big, f_big = ssd_chunked(*tx, chunk=64)  # single chunk
    np.testing.assert_allclose(y4.numpy(), y_big.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f4.numpy(), f_big.numpy(), rtol=1e-4, atol=1e-4)
