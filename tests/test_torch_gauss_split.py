"""gaussian_encode's tensor-core engine's arithmetic, emulated on the CPU (no card).

Above ``GAUSSIAN_WIDE_MIN_Q`` rows of G the dense encode out = G A runs on
``csrc/wide_rows.cuh`` as out^T = A^T G^T: each fp32 element of A and of G
split into three bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v
- hi - mid), six piece products taken (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi,
mid.mid), each exact in fp32, summed in fp32 a stage of 32 rows of K = r at
a time (the last stage zero-padded: r = 500 is 15 stages and 20 rows) and
added stage by stage to the fp32 sums, in a fixed K order.  Here the same
pieces and the same sum structure run in torch at the Gaussian task's K =
500, held to a float64 product: the split's error must be within twice fp32
``torch.matmul``'s, and five products (mid.mid dropped) must not be, so a
wrong piece count shows before the card.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

STAGE = 32  # rows of K a stage (wide_rows.cuh: a 128-byte line of fp32)
SIX = (("mid", "mid"), ("lo", "hi"), ("hi", "lo"), ("mid", "hi"), ("hi", "mid"), ("hi", "hi"))


def _pieces(v: torch.Tensor) -> dict:
    """v = hi + mid + lo exactly, each piece a bf16 value held in fp32."""
    hi = v.to(torch.bfloat16).float()
    mid = (v - hi).to(torch.bfloat16).float()
    lo = (v - hi - mid).to(torch.bfloat16).float()
    return {"hi": hi, "mid": mid, "lo": lo}


def _encode_t(g: torch.Tensor, a: torch.Tensor, products) -> torch.Tensor:
    """out = G A as the engine sums out^T = A^T G^T: W = A^T's pieces (the
    register operand), x = G^T's pieces, per stage of 32 K rows the piece
    products into a fresh fp32 sum, then that sum into out^T."""
    k = g.shape[1]
    k_pad = -(-k // STAGE) * STAGE
    w = torch.nn.functional.pad(a.T, (0, k_pad - k))   # [m, K] zero-padded
    x = torch.nn.functional.pad(g, (0, k_pad - k)).T   # [K, q]
    pw, px = _pieces(w), _pieces(x)
    out_t = torch.zeros(a.shape[1], g.shape[0], dtype=torch.float32)
    for k0 in range(0, k_pad, STAGE):
        part = torch.zeros_like(out_t)
        for ww, wx in products:
            part = part + pw[ww][:, k0:k0 + STAGE] @ px[wx][k0:k0 + STAGE]
        out_t = out_t + part
    return out_t.T


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_pieces_of_g_and_a_sum_to_the_values_exactly():
    rng = np.random.default_rng(1)
    v = torch.as_tensor((rng.standard_normal(50_000) / np.sqrt(500)).astype(np.float32))
    p = _pieces(v)
    assert torch.equal(p["hi"] + p["mid"] + p["lo"], v)
    for name in ("hi", "mid", "lo"):
        assert torch.equal(p[name].to(torch.bfloat16).float(), p[name])


@pytest.mark.parametrize("q,k,m", [(564, 500, 256), (48, 500, 384), (100, 77, 130)])
def test_six_products_match_fp32_and_five_do_not(q, k, m):
    """At the Gaussian task's K = 500 (q = 564, its whole plan; 48, a q just
    over the threshold) and a ragged K = 77, G scaled as the task's
    generator and A a standard normal source."""
    rng = np.random.default_rng(q + k)
    g = (rng.standard_normal((q, k)) / np.sqrt(k)).astype(np.float32)
    a = rng.standard_normal((k, m)).astype(np.float32)
    want = g.astype(np.float64) @ a.astype(np.float64)
    gt, at = torch.as_tensor(g), torch.as_tensor(a)
    fp32 = _rel_err(gt @ at, want)
    six = _rel_err(_encode_t(gt, at, SIX), want)
    five = _rel_err(_encode_t(gt, at, SIX[1:]), want)
    assert six <= 2 * fp32, (six, fp32)
    assert five > 2 * fp32, (five, fp32)
    assert six < 1e-6 < five


def test_padded_stage_adds_nothing():
    """K past r is zero in both operands' pieces: r = 500 in 16 stages (512
    rows) gives the bits of r = 500 with the pad cut off before the split."""
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.standard_normal((40, 500)).astype(np.float32))
    a = torch.as_tensor(rng.standard_normal((500, 64)).astype(np.float32))
    got = _encode_t(g, a, SIX)
    g512 = torch.nn.functional.pad(g, (0, 12))
    a512 = torch.nn.functional.pad(a, (0, 0, 0, 12))
    assert torch.equal(got, _encode_t(g512, a512, SIX))
