"""The wide head engine's arithmetic, emulated on the CPU (no card).

``csrc/wide_rows.cuh`` splits each fp32 operand v into three bf16 pieces,
hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), and takes six
piece products on the tensor cores (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi,
mid.mid), each exact in fp32, summed in fp32 a stage of 32 columns of K at
a time and added stage by stage to the fp32 sums.  Here the same pieces and
the same sum structure run in torch, held to a float64 product at the
served heads' K (768, mamba2-130m; 4096, glm4-9b): the split's error must be
within twice fp32 ``torch.matmul``'s, and five products (mid.mid dropped)
must not be, so a wrong piece count shows before the card.  The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

STAGE = 32  # K columns of a stage (wide_rows.cuh: a 128-byte row of fp32)
SIX = (("mid", "mid"), ("lo", "hi"), ("hi", "lo"), ("mid", "hi"), ("hi", "mid"), ("hi", "hi"))


def _pieces(v: torch.Tensor) -> dict:
    """v = hi + mid + lo exactly, each piece a bf16 value held in fp32."""
    hi = v.to(torch.bfloat16).float()
    mid = (v - hi).to(torch.bfloat16).float()
    lo = (v - hi - mid).to(torch.bfloat16).float()
    return {"hi": hi, "mid": mid, "lo": lo}


def _split_product(a: torch.Tensor, x: torch.Tensor, products) -> torch.Tensor:
    """y = a x as the kernel sums it: per stage the piece products (each
    exact in fp32) into a fresh fp32 sum, then that sum into y."""
    pa, px = _pieces(a), _pieces(x)
    y = torch.zeros(a.shape[0], x.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], STAGE):
        part = torch.zeros_like(y)
        for wa, wx in products:
            part = part + pa[wa][:, k0:k0 + STAGE] @ px[wx][k0:k0 + STAGE]
        y = y + part
    return y


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


def test_pieces_sum_to_the_value_exactly():
    rng = np.random.default_rng(0)
    v = torch.as_tensor((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
                        .astype(np.float32))
    p = _pieces(v)
    assert torch.equal(p["hi"] + p["mid"] + p["lo"], v)
    for name in ("hi", "mid", "lo"):
        assert torch.equal(p[name].to(torch.bfloat16).float(), p[name])


@pytest.mark.parametrize("k", [768, 4096])
def test_six_products_match_fp32_and_five_do_not(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((256, k)).astype(np.float32)
    x = rng.standard_normal((k, 64)).astype(np.float32)
    want = a.astype(np.float64) @ x.astype(np.float64)
    at, xt = torch.as_tensor(a), torch.as_tensor(x)
    fp32 = _rel_err(at @ xt, want)
    six = _rel_err(_split_product(at, xt, SIX), want)
    five = _rel_err(_split_product(at, xt, SIX[1:]), want)
    assert six <= 2 * fp32, (six, fp32)
    assert five > 2 * fp32, (five, fp32)
    assert six < 1e-6 < five
