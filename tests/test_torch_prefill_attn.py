"""The serving prefill's attention on the CPU: ``attention.attention_prefill``.

Its plain version must give, bit for bit, what the prefill's call sites
computed before it (``attention_full`` over Q, K and V projected again,
and the cache rows written from a second K projection roped by
``apply_rope``): the logits and every cache tensor of ``lm_prefill``, for
the attention groups (``_group_full``) and zamba2's shared block
(``_prefill_mamba``).  The route (``prefill_path``) is chosen from the
device, the activations' dtype, the head dimension and the length; a
prefill's ``model.attn`` spans carry it.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``).
"""
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import attention, transformer
from repro_torch.models.attention import (
    CHUNKED_ATTN_THRESHOLD,
    attention_full,
    attention_prefill,
    init_attn,
    prefill_path,
)
from repro_torch.models.layers import apply_rope, rope_table
from repro_torch.utils.trace import Tracer, tracing

KV = torch.bfloat16


def _old_prefill_attention(theta):
    """What a prefill's call site computed before ``attention_prefill``:
    K and V projected for the cache, K roped by ``apply_rope``, then
    ``attention_full`` over its own projections."""
    def old(p, x, rope, cache_k_rows, cache_v_rows, n_real=None):
        positions = torch.arange(x.shape[1])[None, :]
        k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(x.dtype))
        cache_k_rows.copy_(apply_rope(k, positions, theta).to(KV))
        cache_v_rows.copy_(v.to(KV))
        return attention_full(p, x, positions, theta, n_real=n_real)

    return old


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


# (arch, n_heads, n_kv_heads, head_dim, pad_heads): GQA ratios 1, 2 and 4,
# padding heads (n_real), head dimensions 16 and 64, on the attention groups
# (glm4-9b's dense smoke) and zamba2's shared block
CASES = [("glm4-9b", 4, 4, 16, 0), ("glm4-9b", 4, 2, 16, 0), ("glm4-9b", 8, 2, 64, 0),
         ("glm4-9b", 6, 2, 16, 2), ("glm4-9b", 3, 1, 64, 1),
         ("zamba2-1.2b", 4, 4, 16, 0), ("zamba2-1.2b", 4, 2, 64, 0), ("zamba2-1.2b", 8, 2, 16, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,heads,kv,hd,pad", CASES)
def test_plain_attention_prefill_is_the_old_call_sites_bit_for_bit(arch, heads, kv, hd, pad,
                                                                   dtype, monkeypatch):
    """``lm_prefill`` through ``attention_prefill``'s plain version against
    the same prefill with the old call sites' arithmetic in its place: the
    last logits and every cache tensor (the roped K and the V rows among
    them) bit-equal."""
    cfg = get_config(arch, smoke=True).scaled(n_heads=heads, n_kv_heads=kv, head_dim=hd,
                                              pad_heads=pad, dtype=dtype)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 13), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = transformer.lm_prefill(params, cfg, tokens, s_max=17)
        monkeypatch.setattr(transformer, "attention_prefill", _old_prefill_attention(cfg.rope_theta))
        want = transformer.lm_prefill(params, cfg, tokens, s_max=17)
    assert torch.equal(got[0], want[0])
    gl, wl = dict(_leaves(got[1])), dict(_leaves(want[1]))
    assert gl.keys() == wl.keys()
    assert any(t.dtype == KV for t in gl.values())
    for name, t in gl.items():
        assert torch.equal(t, wl[name]), name


@pytest.mark.parametrize("s,heads,kv,n_real", [(1, 2, 1, None), (37, 4, 2, 3),
                                              (CHUNKED_ATTN_THRESHOLD, 2, 1, None)])
def test_plain_attention_prefill_matches_attention_full_and_the_roped_rows(s, heads, kv, n_real):
    """One layer: the output is ``attention_full``'s (at 8192 tokens both
    take the fp32 ``_sdpa_chunked``), the cache rows the roped K and the V
    in bf16; rows past S are left alone."""
    hd, d, theta = 16, 32, 1e4
    g = torch.Generator().manual_seed(s)
    p = init_attn(g, d, heads, kv, hd, torch.float32, "cpu")
    x = torch.randn(1, s, d, generator=g).to(torch.bfloat16)
    positions = torch.arange(s)[None, :]
    ck = torch.full((1, s + 3, kv, hd), 7.0, dtype=KV)
    cv = torch.full((1, s + 3, kv, hd), 7.0, dtype=KV)
    with torch.no_grad():
        out = attention_prefill(p, x, rope_table(positions, hd, theta), ck[:, :s], cv[:, :s],
                                n_real=n_real)
        want = attention_full(p, x, positions, theta, n_real=n_real)
        k = torch.einsum("bsd,dhk->bshk", x, p["w_k"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, p["w_v"].to(x.dtype))
    assert torch.equal(out, want)
    assert torch.equal(ck[:, :s], apply_rope(k, positions, theta).to(KV))
    assert torch.equal(cv[:, :s], v.to(KV))
    assert bool((ck[:, s:] == 7).all()) and bool((cv[:, s:] == 7).all())


def _x(is_cuda, dtype, s):
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=(1, s, 4096))


@pytest.mark.parametrize("is_cuda,dtype,hd,s,want", [
    (True, torch.bfloat16, 128, 1024, "kernel"),
    (True, torch.bfloat16, 64, 4096, "kernel"),
    (True, torch.bfloat16, 128, 1, "kernel"),
    (True, torch.bfloat16, 128, CHUNKED_ATTN_THRESHOLD - 1, "kernel"),
    (True, torch.bfloat16, 128, CHUNKED_ATTN_THRESHOLD, "long"),
    (True, torch.bfloat16, 64, 32768, "long"),
    (True, torch.bfloat16, 96, 1024, "head_dim"),
    (True, torch.bfloat16, 192, 1024, "head_dim"),
    (True, torch.bfloat16, 96, CHUNKED_ATTN_THRESHOLD, "head_dim"),
    (True, torch.float32, 128, 1024, "dtype"),
    (False, torch.bfloat16, 128, 1024, "device"),
])
def test_prefill_path_routes_by_device_dtype_head_dim_and_length(is_cuda, dtype, hd, s, want):
    assert prefill_path(_x(is_cuda, dtype, s), hd) == want


@pytest.mark.parametrize("arch", [n for n, c in ARCHS.items()
                                  if c.family in ("dense", "moe", "vlm", "hybrid")])
def test_each_configs_prefill_route_on_the_card(arch):
    """The route every served config's self-attention takes at a 1024-token
    bf16 prompt on the card: the kernel at head dimension 64 or 128
    (glm4-9b, llama-3.2-vision-11b, dbrx-132b, llama4, nemotron-4-15b,
    zamba2-1.2b's shared block), plain ``_sdpa`` for phi3-mini (96) and
    nemotron-4-340b (192)."""
    cfg = get_config(arch)
    want = {"phi3-mini-3.8b": "head_dim", "nemotron-4-340b": "head_dim"}.get(arch, "kernel")
    assert prefill_path(_x(True, getattr(torch, cfg.dtype), 1024), cfg.resolved_head_dim) == want


@pytest.mark.parametrize("arch", ["glm4-9b", "zamba2-1.2b", "llama-3.2-vision-11b"])
def test_prefill_attn_spans_carry_the_route(arch):
    """Under a tracer every ``model.attn`` span of a prefill carries
    ``path`` (``device`` on the CPU), one a self-attention layer; a decode
    step's carry none."""
    cfg = get_config(arch, smoke=True)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 6), generator=torch.Generator().manual_seed(1))
    img = None
    if cfg.family == "vlm":
        img = torch.randn(1, cfg.img_tokens, cfg.d_model, generator=torch.Generator().manual_seed(2))
    tr = Tracer(clock=time.perf_counter)
    with torch.no_grad(), tracing(tr):
        _, cache = transformer.lm_prefill(params, cfg, tokens, img=img, s_max=8)
        n_prefill = len(tr.spans)
        transformer.lm_decode_step(params, cfg, cache, tokens[:, -1])
    prefill = [s for s in tr.spans[:n_prefill] if s.name == "model.attn"]
    decode = [s for s in tr.spans[n_prefill:] if s.name == "model.attn"]
    n_attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers)
    assert len(prefill) == len(decode) == n_attn
    assert all(s.attrs.get("path") == "device" for s in prefill)
    assert not any("path" in s.attrs for s in decode)


def test_prefill_kernel_route_raises_without_a_card(monkeypatch):
    """Where the route says ``kernel`` the wrapper launches or raises: on
    CPU tensors it raises, and nothing falls back."""
    monkeypatch.setattr(attention, "prefill_path", lambda x, hd: "kernel")
    g = torch.Generator().manual_seed(0)
    p = init_attn(g, 32, 2, 1, 64, torch.bfloat16, "cpu")
    x = torch.randn(1, 5, 32, generator=g).to(torch.bfloat16)
    rope = rope_table(torch.arange(5)[None, :], 64, 1e4)
    ck, cv = torch.zeros(1, 5, 1, 64, dtype=KV), torch.zeros(1, 5, 1, 64, dtype=KV)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        attention_prefill(p, x, rope, ck, cv)
