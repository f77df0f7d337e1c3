#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # as run on the card; needs one GPU
    python3 chip_smoke.py --profile    # also a torch.profiler window over engine steps
    python3 chip_smoke.py --sweep-lt   # only: build, the encode kernels' checks, and
                                       # lt_encode's span sweep at the LT task's shape
                                       # (variants of lt_encode.cu built under build/)

A kernel that has a library call computing the same function is timed in
turns with it on the one card (kernel, library, library, kernel); its row
prints ms, library_ms, their ratio, bound_ms and the share of the bound.

Phases, one JSON line each; any failure exits non-zero before the last line:

1. device: name, ``nvidia-smi`` name and power limit, kernel build seconds
   (one ``nvcc`` per source, started together);
2. kernels: the serving kernels against their plain PyTorch versions on the
   card, at the serving path's shapes (glm4-9b head at B = 1 and B = 4, the
   (13, 3) parity re-encode, the mesh head's [10826, 4096] code block; the
   mamba2-130m and zamba2-1.2b heads and raises; ``ssd_chunk`` and
   ``ssd_combine`` at both Mamba-2 widths for prompts of 4096, 1000 (padded
   to 1024), 100 and 2 tokens in bf16 and fp32, under the reference tests'
   decay and a slow one that keeps every tile in sight, a cell whose exp
   overflows above the diagonal, and ``ssd_forward`` with h0) and at
   ragged, fp16 and misaligned shapes; max error against the stated tolerance, kernel /
   plain / library times and the bound;
3. task, LT: the paper's coded task form (§5.1 scenario 1: r = 5,000, five
   EC2 workers, m = 500,000) through ``ClusterEmulator.run_task`` — Algorithm
   1, LT encode with the reserve rows encoded on the card by ``lt_encode``,
   adaptive top-ups under churn (worker 0 dies, worker 1 slows 5x), the
   streaming peeling decode — held to A·x in float64 and to a host-encode
   run of the same seed; then ``lt_encode`` against its plain version, bit
   for bit, at that call's shapes and at ragged ones: at the task's shape
   the kernel alone on the CSR that ``torch.sparse.mm`` also gets
   (``kernel_ms``, in turns with it), the call as ``run_task`` makes it
   (``ms``) and its compaction (``compaction_ms``).  The reserve is encoded with
   ``TaskSpec``'s default ``encode_mode`` ('device': the card).  m is cut
   only if host memory is short, and the cut is printed;
4. task, Gaussian: the same at r = 500 (scenario 2's r/20, ten workers),
   m = 200,000, ``code="gaussian"``, the reserve encoded by
   ``gaussian_encode`` (printed as a cut: the host's dense static encode,
   run twice, sets the size);
5. head and serve: glm4-9b's coded head at full width under 0 and 2
   erasures; glm4-9b at full width and depth (seeded init on the card),
   4 slots, 6 requests of 16 prompt tokens and 8 new tokens, 3 persistent
   stragglers forcing one (14, 2) -> (13, 3) raise;
6. mesh head: the same head through ``coded_head_matvec(mesh=...)`` on a
   head mesh of sixteen logical devices on the one card (printed as a
   cut), one ``coded_matvec`` launch per code block, under 0, 1 and 2
   erasures, held to the uncoded head and to the fused single-device head;
7. mesh serve: ``ServeEngine(mesh=...)`` over the serve phase's params and
   workload, its greedy tokens held to the single-device serve's;
8. ssm serve and hybrid serve: mamba2-130m and zamba2-1.2b at full width
   and depth (seeded init on the card), coded head, 4 slots, six requests of
   4096, 4096, 1000, 1000, 100 and 2 prompt tokens and 8 new tokens, the
   same three stragglers forcing the raise; every Mamba block's prefill runs
   ``ssd_chunk`` and ``ssd_combine`` (24 x 6 and 38 x 6 launches); prefill
   ms per prompt length, whole-step ms, tokens/s, peak memory, the float32
   prefill logits with the SSD kernels against the plain SSD on the card,
   and block 0's SSD of the served bf16 prefill against its plain route;
9. a ``kernels`` line with every kernel on every path it runs (launch
   counts read around that path's run; ``lt_encode``'s ``ms`` is the
   call with its compaction, its ``kernel_ms`` the kernel alone, which its
   ``library_ms`` is held to), then the device line.

It imports nothing of JAX, and exits non-zero without CUDA or without the
repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12           # H100 SXM fp32 outside the tensor cores (data sheet)
PAPER_M = 500_000            # the paper's width of A (benchmarks/paper_ec2.py)
GAUSSIAN_TASK_M = 200_000    # the Gaussian task's cut width (phase_task_gaussian)
TASK_TIME_SCALE = 10.0       # wall seconds per model second of the paced task runs


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_turns(torch, kernel, library, iters: int, warmup: int = 2) -> tuple[float, float, list]:
    """A kernel and its library call timed in turns on one card (kernel,
    library, library, kernel), each turn the mean over ``iters`` launches;
    returns (kernel ms, library ms, the four turns)."""
    turns = [time_ms(torch, fn, iters, warmup) for fn in (kernel, library, library, kernel)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def against_library(row: dict, ms_key: str = "ms") -> dict:
    """The row's ratio to its library call and share of its bound."""
    row["ratio"] = row[ms_key] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row[ms_key]
    return row


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|), both as floats."""
    return float((got - want).abs().max()), float(want.abs().max())


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# --------------------------------------------------------------------------
def phase_device(torch):
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    nvcc_s = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in _build.ptxas_report(name).splitlines()
               if "entry function" in ln or "registers" in ln or "spill" in ln]
        for name in _build.SOURCES
    }
    emit({"phase": "device", "torch_device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "nvcc_parallel_s": nvcc_s, "ptxas": ptxas})
    return smi


def phase_kernels(torch, gen, results: dict) -> None:
    from repro_torch.core.decoding import get_decoder_cache
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rtol = 1e-4  # |kernel - plain| <= rtol * max(1, max|plain|): fp32, other sum order

    # ---- coded_matvec_decode: glm4-9b head (14 + 2 blocks of 10826 rows x 4096)
    # plus ragged shapes (odd br, M % 4 != 0 -> scalar loads, B up to 16)
    # plus the mamba2-130m (tied, [50280, 768]) and zamba2-1.2b ([32000,
    # 2048]) heads: br = ceil(vocab / n_data)
    head_shapes = [("glm4-9b prefill", 14, 2, 10826, 4096, 1),
                   ("glm4-9b decode", 14, 2, 10826, 4096, 4),
                   ("glm4-9b decode after raise", 13, 3, 11658, 4096, 4),
                   ("mamba2-130m decode", 14, 2, 3592, 768, 4),
                   ("mamba2-130m decode after raise", 13, 3, 3868, 768, 4),
                   ("zamba2-1.2b decode", 14, 2, 2286, 2048, 4),
                   ("zamba2-1.2b decode after raise", 13, 3, 2462, 2048, 4),
                   ("ragged", 13, 3, 1001, 4097, 3),
                   ("ragged", 6, 2, 77, 516, 16)]
    timed = ("glm4-9b prefill", "glm4-9b decode", "mamba2-130m decode", "zamba2-1.2b decode")
    for label, n_data, n_parity, br, m, b in head_shapes:
        nb = n_data + n_parity
        w = torch.randn(nb * br, m, device=dev, generator=gen)
        x = torch.randn(m, b, device=dev, generator=gen)
        cache = get_decoder_cache(n_data, n_parity)
        for erased in ((), (1, nb - 1)):
            mask = torch.ones(nb, device=dev)
            mask[list(erased)] = 0.0
            rec = cache.recovery(mask)
            got = ops.coded_matvec_decode(w, x, rec, mode="cuda")
            want = ref.ref_coded_matvec_decode(w, x, rec)
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, want)
            tol = rtol * max(1.0, scale)
            row = {"phase": "kernel", "kernel": "coded_matvec_decode", "shape": label,
                   "w": [nb * br, m], "b": b, "erased": list(erased),
                   "max_abs_err": err, "tol": tol}
            if not erased and label in timed:
                iters = 20
                row["ms"] = time_ms(torch, lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"), iters)
                row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec_decode(w, x, rec), iters)
                row["library_ms"] = time_ms(torch, lambda: torch.matmul(w, x), iters)
                row["library_call"] = "torch.matmul(W_c, x), the block product alone (partial yardstick)"
                n_bytes = 4 * (w.numel() + x.numel() + rec.numel() + n_data * br * b)
                n_ops = 2 * nb * br * m * b + 2 * n_data * nb * br * b
                row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
                results.setdefault("coded_matvec_decode", {})[label] = row
            emit(row)
            check(err <= tol, f"coded_matvec_decode {label} erased={erased}: {err} > {tol}")
        del w, x
    torch.cuda.empty_cache()

    kernel_gaussian(torch, gen, results)
    kernel_coded_matvec(torch, gen, results)
    kernel_ssd(torch, results)
    # launches made for these comparisons are not the main path's
    _reset_launches()


def gaussian_row(torch, g, a, label: str, timed_iters: int = 0) -> dict:
    """gaussian_encode on (G, A) against ref_gaussian_encode, to 1e-4 x
    max(1, max|plain|) (fp32, another sum order); with ``timed_iters``, also
    timed in turns with torch.matmul(G, A), beside its plain version and bound."""
    from repro_torch.kernels import ops, ref

    (q, r), m = g.shape, a.shape[1]
    got = ops.gaussian_encode(g, a, mode="cuda")
    want = ref.ref_gaussian_encode(g, a)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    tol = 1e-4 * max(1.0, scale)
    row = {"phase": "kernel", "kernel": "gaussian_encode", "shape": label,
           "g": [q, r], "a": [r, m], "max_abs_err": err, "tol": tol}
    del got, want
    if timed_iters:
        row["ms"], row["library_ms"], row["turns_ms"] = time_turns(
            torch, lambda: ops.gaussian_encode(g, a, mode="cuda"), lambda: torch.matmul(g, a),
            timed_iters)
        row["library_call"] = "torch.matmul(G, A)"
        row["plain_ms"] = time_ms(torch, lambda: ref.ref_gaussian_encode(g, a), timed_iters)
        row["bound_ms"], row["bound_by"] = bound(4 * (q * r + r * m + q * m), 2 * q * r * m)
        against_library(row)
    emit(row)
    check(err <= tol, f"gaussian_encode {label}: {err} > {tol}")
    return row


def kernel_gaussian(torch, gen, results: dict) -> None:
    """gaussian_encode at the (13, 3) parity re-encodes of the glm4-9b,
    mamba2-130m and zamba2-1.2b heads, G [16, 13] x A [13, br * d_model],
    timed; then ragged shapes: every q-tile edge, an r across G's
    shared-memory panel, M = 1, M % 4 != 0 and a misaligned view of A
    (scalar loads)."""
    dev = torch.device("cuda")
    enc_shapes = [("glm4-9b raise", 16, 13, 11658 * 4096),
                  ("mamba2-130m raise", 16, 13, 3868 * 768),
                  ("zamba2-1.2b raise", 16, 13, 2462 * 2048),
                  ("ragged", 33, 40, 257), ("ragged", 5, 3, 1001), ("ragged", 16, 14, 1),
                  *(("ragged q-tile edge", q, 13, 100_003) for q in (1, 8, 9, 17, 26, 32, 33, 70)),
                  ("ragged r across panels", 32, 1500, 20_000),
                  ("misaligned view", 26, 500, 20_000)]
    for label, q, r, m in enc_shapes:
        g = torch.randn(q, r, device=dev, generator=gen)
        if label.startswith("misaligned"):
            a = torch.randn(1 + r * m, device=dev, generator=gen)[1:].view(r, m)
            check(a.data_ptr() % 16 != 0, "the misaligned view is aligned")
        else:
            a = torch.randn(r, m, device=dev, generator=gen)
        timed = label.endswith("raise")
        row = gaussian_row(torch, g, a, label, 10 if timed else 0)
        if timed:
            results.setdefault("gaussian_encode", {})[label] = row
        del g, a
    torch.cuda.empty_cache()


def kernel_coded_matvec(torch, gen, results: dict) -> None:
    """coded_matvec against ref_coded_matvec: the mesh head's code block of
    glm4-9b ([10826, 4096], B = 1 and 4; [11658, 4096] after the (13, 3)
    raise), the whole W_c [173216, 4096] (``kernels.ops.coded_matvec``'s
    single-device form), ragged shapes, fp16, and a misaligned block view."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    shapes = [  # label, rows, M, B, dtype, timed
        ("glm4-9b block prefill", 10826, 4096, 1, torch.float32, True),
        ("glm4-9b block decode", 10826, 4096, 4, torch.float32, True),
        ("glm4-9b block after raise", 11658, 4096, 4, torch.float32, True),
        ("glm4-9b whole W_c", 173216, 4096, 4, torch.float32, True),
        ("glm4-9b block decode fp16", 10826, 4096, 4, torch.float16, True),
        ("ragged", 513, 129, 3, torch.float32, False),
        ("ragged", 100, 70, 1, torch.float32, False),
        ("ragged", 1, 4096, 1, torch.float32, False),
        ("ragged fp16", 513, 129, 3, torch.float16, False),
        ("misaligned block view", 1001, 4097, 4, torch.float32, False),
    ]
    for label, rows, m, b, dtype, timed in shapes:
        if label.startswith("misaligned"):
            # block 3 of a 16-block coded weight with M odd: starts 4 bytes
            # past a 16-byte boundary, so the kernel takes its scalar loads
            whole = torch.randn(16 * rows, m, device=dev, generator=gen)
            a = whole.chunk(16)[3]
            check(a.data_ptr() % 16 != 0, "the misaligned view is aligned")
        else:
            a = torch.randn(rows, m, device=dev, generator=gen).to(dtype)
        x = torch.randn(m, b, device=dev, generator=gen).to(dtype)
        if b == 1:
            x = x[:, 0]
        got = ops.coded_matvec(a, x, mode="cuda")
        want = ref.ref_coded_matvec(a, x)
        torch.cuda.synchronize()
        err, scale = max_err(torch, got, want)
        # fp32: 1e-4 * max(1, max|plain|), another sum order; fp16 inputs
        # (fp32 sums in both): the reference's fp16 bound, 2e-3
        tol = (1e-4 if dtype == torch.float32 else 2e-3) * max(1.0, scale)
        row = {"phase": "kernel", "kernel": "coded_matvec", "shape": label,
               "a": [rows, m], "b": b, "dtype": str(dtype).removeprefix("torch."),
               "max_abs_err": err, "tol": tol}
        del got, want
        if timed:
            iters = 10 if rows > 100_000 else 50
            row["ms"] = time_ms(torch, lambda: ops.coded_matvec(a, x, mode="cuda"), iters)
            row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec(a, x), iters)
            row["library_ms"] = time_ms(torch, lambda: torch.matmul(a, x), iters)
            row["library_call"] = f"torch.matmul(A, x) in {row['dtype']}"
            n_bytes = a.element_size() * (a.numel() + x.numel()) + 4 * rows * b
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * rows * m * b)
            results.setdefault("coded_matvec", {})[label] = row
        emit(row)
        check(err <= tol, f"coded_matvec {label}: {err} > {tol}")
        del a, x
    torch.cuda.empty_cache()


# the SSD widths of the two Mamba-2 configs: heads, head dim P, state N
SSD_WIDTHS = {"mamba2-130m": (32, 48, 128), "zamba2-1.2b": (64, 64, 64)}
SSD_PROMPTS = (4096, 1000, 100, 2)   # tokens: Q = 256 (nc 16), 256 (padded, nc 4), 100, 2
SSD_TIMED = 4096                     # the prompt whose cells are timed


def _ssd_cells(torch, gen, heads: int, p: int, n: int, s: int, dtype, draw: str = "reference"):
    """The cells ssd_forward hands the kernels for one prompt of s tokens
    (B = 1, one B/C group): x [G, Q, P], da [G, Q], b, c [G, Q, N] with
    G = heads * nc, the prompt zero-padded to a chunk multiple as the model
    pads it.  The decay da comes from one of three draws:

    * ``reference``: as the reference's kernel tests draw it
      (``tests/test_kernels.py``: -0.3 |N(0, 1)|).  |cum| stays under ~100,
      so an ulp of it is under 1e-5; but at Q = 256 exp(cum) falls below
      e^-15 after ~64 positions, so only the first row tile of y_off, the
      s-tiles next to the diagonal in y_diag and the last positions of the
      state reduction are large enough to see;
    * ``slow``: -U(0, 2/Q), so |cum| <= 2 over the chunk and every row tile,
      every s-tile and every stage of the state reduction carries weight
      within e^-2 of the largest;
    * ``overflow``: every step decays by e^-20 or more, so exp above the
      diagonal overflows."""
    dev = torch.device("cuda")
    q = min(256, s)
    nc = -(-s // q)
    g = heads * nc
    if draw == "reference":
        da = -0.3 * torch.randn(heads, nc, q, device=dev, generator=gen).abs()
    elif draw == "slow":
        da = -(2.0 / q) * torch.rand(heads, nc, q, device=dev, generator=gen)
    else:
        da = -60.0 * torch.randn(heads, nc, q, device=dev, generator=gen).abs() - 20.0
    x = 0.1 * torch.randn(heads, nc, q, p, device=dev, generator=gen)
    b = 0.3 * torch.randn(heads, nc, q, n, device=dev, generator=gen)
    c = 0.3 * torch.randn(heads, nc, q, n, device=dev, generator=gen)
    pad = nc * q - s
    if pad:
        for t in (x, da, b, c):
            t[:, -1, q - pad:] = 0.0
    return (x.reshape(g, q, p).to(dtype).contiguous(), da.reshape(g, q).contiguous(),
            b.reshape(g, q, n).to(dtype).contiguous(), c.reshape(g, q, n).to(dtype).contiguous())


def _ssd_check(torch, got, want) -> tuple[float, float, bool]:
    """(max |got - want|, the allowed max, within it and finite): the
    reference's rtol 1e-4 and atol 1e-5, both scaled by max|want|, as every
    kernel check here."""
    err = float((got - want).abs().max())
    tol = 1e-4 * float(want.abs().max()) + 1e-5 * max(1.0, float(want.abs().max()))
    return err, tol, bool(torch.isfinite(got).all()) and err <= tol


def kernel_ssd(torch, results: dict) -> None:
    """ssd_chunk and ssd_combine against ref_ssd_chunk / ref_ssd_combine on
    the card, at both Mamba-2 configs' widths, for prompts of 4096, 1000
    (padded to 1024), 100 and 2 tokens, in bf16 (the serve's) and fp32,
    each with the reference tests' decay and with a slow one that keeps
    every tile in sight (``_ssd_cells``); an overflowing cell; and
    ssd_forward with h0 against its plain route, under both draws.  The
    4096-token bf16 cells of the reference draw are timed."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    for arch, (heads, p, n) in SSD_WIDTHS.items():
        cases = [(s, dt, draw) for draw in ("reference", "slow") for s in SSD_PROMPTS
                 for dt in (torch.bfloat16, torch.float32)]
        cases.append((SSD_TIMED, torch.bfloat16, "overflow"))
        for s, dtype, draw in cases:
            x, da, b, c = _ssd_cells(torch, gen, heads, p, n, s, dtype, draw)
            g, q = da.shape
            got = ssd_chunk_cuda(x, da, b, c)
            want = ref.ref_ssd_chunk(x, da, b, c)
            s_in = 0.1 * torch.randn(g, p, n, device=dev, generator=gen)
            y_off = ssd_combine_cuda(c, want[3], s_in)
            y_off_want = ref.ref_ssd_combine(c, want[3], s_in)
            torch.cuda.synchronize()
            dname = str(dtype).removeprefix("torch.")
            label = f"{arch} {s} {dname}" + ("" if draw == "reference" else f" {draw}")
            checks = dict(zip(("y_diag", "states", "decay", "cum"),
                              (_ssd_check(torch, gv, wv) for gv, wv in zip(got, want))))
            comb = _ssd_check(torch, y_off, y_off_want)
            row_c = {"phase": "kernel", "kernel": "ssd_chunk", "shape": label, "g": g, "q": q,
                     "p": p, "n": n, "dtype": dname, "da_draw": draw,
                     "errors": {k: v[0] for k, v in checks.items()},
                     "tols": {k: v[1] for k, v in checks.items()},
                     "max_abs_err": checks["y_diag"][0], "tol": checks["y_diag"][1]}
            row_m = {"phase": "kernel", "kernel": "ssd_combine", "shape": label, "g": g, "q": q,
                     "p": p, "n": n, "dtype": dname, "da_draw": draw,
                     "max_abs_err": comb[0], "tol": comb[1]}
            if s == SSD_TIMED and dtype == torch.bfloat16 and draw == "reference":
                elt = x.element_size()
                row_c["ms"] = time_ms(torch, lambda: ssd_chunk_cuda(x, da, b, c), 20)
                row_c["plain_ms"] = time_ms(torch, lambda: ref.ref_ssd_chunk(x, da, b, c), 3)
                row_c["library_ms"] = None  # no one PyTorch call computes it
                # each input read once, each output written once; the two
                # Q x Q products over their causal half (l >= s), which is
                # all the function needs: q(q+1)/2 entries of C·Bᵀ over N
                # and of (C·Bᵀ ∘ L)·X over P, then Xᵀ·(decayed B)
                n_bytes = elt * g * q * (p + 2 * n) + 4 * (g * q + g * q * p + g * p * n + g + g * q)
                n_ops = g * (q * (q + 1) * (n + p) + 2 * q * p * n)
                row_c["bound_ms"], row_c["bound_by"] = bound(n_bytes, n_ops)
                cum = want[3]
                row_m["ms"] = time_ms(torch, lambda: ssd_combine_cuda(c, cum, s_in), 20)
                row_m["plain_ms"] = time_ms(torch, lambda: ref.ref_ssd_combine(c, cum, s_in), 5)
                row_m["library_ms"] = time_ms(
                    torch, lambda: torch.einsum("gln,gpn,gl->glp", c.float(), s_in, cum.exp()), 5)
                row_m["library_call"] = ("torch.einsum('gln,gpn,gl->glp', C.float(), S_in, "
                                         "exp(cum))")
                n_bytes = elt * g * q * n + 4 * (g * q + g * p * n + g * q * p)
                row_m["bound_ms"], row_m["bound_by"] = bound(n_bytes, g * (2 * q * n * p + q * p))
                results.setdefault("ssd_chunk", {})[label] = row_c
                results.setdefault("ssd_combine", {})[label] = row_m
            emit(row_c)
            emit(row_m)
            for k, (err, tol, ok) in checks.items():
                check(ok, f"ssd_chunk {label} {k}: max err {err}, allowed {tol}")
            check(comb[2], f"ssd_combine {label}: max err {comb[0]}, allowed {comb[1]}")
            del x, da, b, c, got, want, s_in, y_off, y_off_want
        # ssd_forward with h0: a 1000-token prompt zero-padded to 1024 (as
        # the model pads it), in the model's [B, S, H, F] layout, with one
        # B/C group; kernels against the plain route on the card
        def model_layout(t):  # cells [H * nc, Q, F] -> [1, nc * Q, H, F]
            return t.reshape(heads, 1024, -1).permute(1, 0, 2)[None].contiguous()

        for draw in ("reference", "slow"):
            x, da, b, c = (model_layout(t) for t in
                           _ssd_cells(torch, gen, heads, p, n, 1000, torch.bfloat16, draw))
            da = da[..., 0]
            b, c = b[:, :, :1].contiguous(), c[:, :, :1].contiguous()
            h0 = 0.1 * torch.randn(1, heads, p, n, device=dev, generator=gen)
            y, final = ops.ssd_forward(x, da, b, c, 256, mode="cuda", h0=h0)
            y_p, final_p = ops.ssd_forward(x, da, b, c, 256, mode="off", h0=h0)
            torch.cuda.synchronize()
            f_err, f_tol, f_ok = _ssd_check(torch, final, final_p)
            y_err = float((y.float() - y_p.float()).abs().max())
            # y is cast back to bf16: within one bf16 step (2^-7 relative)
            y_ok = bool(torch.isfinite(y).all()) and bool(torch.allclose(
                y.float(), y_p.float(), rtol=2.0 ** -7, atol=1e-5 * float(y_p.float().abs().max())))
            emit({"phase": "kernel", "kernel": "ssd_forward h0",
                  "shape": f"{arch} 1024 bfloat16", "da_draw": draw,
                  "final_max_abs_err": f_err, "final_tol": f_tol, "y_max_abs_err": y_err})
            check(f_ok and y_ok, f"ssd_forward with h0 at {arch}, {draw} decay: "
                                 f"final {f_err}, y {y_err}")
            del x, da, b, c, h0, y, final, y_p, final_p
    torch.cuda.empty_cache()


def _kernel_wrappers() -> dict:
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    return {"coded_matvec": coded_matvec_cuda,
            "coded_matvec_decode": coded_matvec_decode_cuda,
            "gaussian_encode": gaussian_encode_cuda,
            "lt_encode": lt_encode_cuda,
            "ssd_chunk": ssd_chunk_cuda,
            "ssd_combine": ssd_combine_cuda}


def _reset_launches() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _host_peak_gb() -> float:
    """Peak resident memory of this process so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("MemAvailable not in /proc/meminfo")


def _task_inputs(torch, r: int, m: int, seed: int):
    """A [r, m] and x [m], fp32, drawn on the card from ``seed``; A·x in
    float64 on the card (in row pieces); all three copied to the host."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    a_dev = torch.randn(r, m, device=dev, generator=gen)
    x_dev = torch.randn(m, device=dev, generator=gen)
    x64 = x_dev.double()
    step = max(1, (1 << 30) // (8 * m))
    y = torch.cat([a_dev[s:s + step].double() @ x64 for s in range(0, r, step)])
    out = a_dev.cpu().numpy(), x_dev.cpu().numpy(), y.cpu().numpy()
    del a_dev, x_dev, x64, y
    torch.cuda.empty_cache()
    return out


def _churn(r: int):
    """Worker 0 dies and worker 1 slows 5x: the reference's executor test,
    with its times scaled by r / 400."""
    from repro_torch.core.adaptive import ChurnEvent, ChurnSchedule

    s = r / 400
    return ChurnSchedule((ChurnEvent(t=0.01 * s, worker=0, kind="death"),
                          ChurnEvent(t=0.008 * s, worker=1, kind="rate", factor=5.0)))


def _run_task(torch, a, x, y_ref, workers, code: str, encode_mode,
              seed: int) -> tuple[dict, object, object]:
    """One ``run_task`` of the adaptive task form, its launches counted around
    it; returns (row, result, emulator)."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec
    from repro_torch.core.adaptive import ReallocationPolicy

    spec = TaskSpec(scheme="bpcc", code=code, adaptive=ReallocationPolicy(),
                    churn=_churn(a.shape[0]), encode_mode=encode_mode)
    em = ClusterEmulator(workers, time_scale=TASK_TIME_SCALE, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    res = em.run_task(a, x, spec)
    wall = time.perf_counter() - t0
    launches = _launches()
    rel = float(np.abs(res.y - y_ref).max() / np.abs(y_ref).max())
    row = {"encode_mode": encode_mode, "ok": res.ok, "max_rel_err": rel,
           "t_complete": res.t_complete, "t_decode": res.t_decode,
           "t_decode_ingest": res.t_decode_ingest, "t_wall": res.t_wall,
           "run_task_wall_s": wall, "rows_assigned": res.rows_assigned,
           "rows_received": res.rows_received, "reallocations": len(res.reallocations),
           "launches": launches, "host_peak_gb": _host_peak_gb(),
           "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    enc = em.last_encode
    if enc is not None:
        row["encode"] = {k: enc[k] for k in ("kind", "rows", "nonzeros", "h2d_s",
                                             "encode_s", "d2h_s", "static_host_s")}
    return row, res, em


def _same_trajectory(dev_res, host_res) -> bool:
    return (dev_res.arrivals == host_res.arrivals
            and dev_res.reallocations == host_res.reallocations
            and dev_res.rows_assigned == host_res.rows_assigned)


def phase_task_lt(torch, args, results: dict, smi: str) -> None:
    """The paper's task form at scenario 1 through the port's run_task, the
    reserve rows LT-encoded on the card by TaskSpec's default encode_mode;
    then lt_encode at that call's shapes."""
    from repro_torch.cluster import ec2_scenario

    r, workers = ec2_scenario(1)
    m, cut = PAPER_M, None
    # host bytes per A byte, the process's peak on this path: A, the coded
    # rows (capacity ~1.75 r) held once by the master and once spread over
    # the workers, the static encode's buffer, and room for the reference
    # copy of y and the encode's pieces
    need_per_col = 6.0 * r * 4 / 1e9
    avail = _mem_available_gb()
    if need_per_col * m > 0.9 * avail:
        cut = {"m": int(0.9 * avail / need_per_col), "of_m": m,
               "reason": f"host memory: {avail:.1f} GB available, "
                         f"{need_per_col * m:.1f} GB reckoned at m = {m}"}
        emit({"phase": "cut", "task": "lt", **cut})
        m = cut["m"]
    t0 = time.perf_counter()
    a, x, y_ref = _task_inputs(torch, r, m, args.seed)
    inputs_s = time.perf_counter() - t0
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "lt", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran: the top-ups drew no reserve rows")
    plan = enc["plan"]
    static_total = dev_row["rows_assigned"] - enc["rows"]
    del em
    host_row, host_res, em = _run_task(torch, a, x, y_ref, workers, "lt", None,
                                       args.seed)
    del em
    row = {"phase": "task", "code": "lt", "scenario": 1, "r": r, "m": m,
           "cut": cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE, "inputs_s": inputs_s, "static_rows": static_total,
           "device_encode": dev_row, "host_encode": host_row,
           "same_trajectory": _same_trajectory(dev_res, host_res),
           "y_max_abs_diff_device_vs_host": float(np.abs(dev_res.y - host_res.y).max()),
           "card": smi}
    emit(row)
    results["task_lt"] = row
    check(dev_res.ok, "LT task (device encode) did not decode")
    check(dev_row["max_rel_err"] <= 2e-3, f"LT task rel err {dev_row['max_rel_err']} > 2e-3")
    check(dev_row["rows_assigned"] > static_total, "top-ups drew no reserve rows")
    check(dev_row["launches"]["lt_encode"] == 1, f"lt_encode launches {dev_row['launches']}")
    check(host_res.ok and host_row["max_rel_err"] <= 2e-3,
          f"LT task (host encode) rel err {host_row['max_rel_err']}")
    check(row["same_trajectory"], "device and host encode runs differ in arrivals, "
                                  "reallocations or rows assigned")
    del dev_res, host_res
    gc.collect()

    kernel_lt_encode(torch, a, plan, results)
    del a, x, y_ref, plan
    gc.collect()
    torch.cuda.empty_cache()


def kernel_lt_encode(torch, a_host, plan, results: dict) -> None:
    """lt_encode on the card against ref_lt_encode, bit for bit: the task
    phase's own call (A [r, m], its reserve slice of the plan) in full, and
    ragged shapes.  At the task's shape the kernel alone, on the CSR that
    torch.sparse.mm also gets, is timed in turns with it; the call as
    run_task makes it (compaction and kernel) and the compaction alone
    beside them."""
    from repro_torch.core.encoding import LTCode
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import _lt_csr, _lt_launch, lt_encode_cuda

    dev = torch.device("cuda")
    gen = np.random.default_rng(7)
    shapes = [("task reserve slice", torch.as_tensor(a_host, device=dev),
               plan.indices, plan.coeffs)]
    # ragged: M % 4 != 0 (scalar loads); zeros mid-row with non-unit
    # coefficients and a degree-0 row; q = 1 with d_max = 1; rows of degree
    # over 64 (heavy units) across many 128-column spans
    lt = LTCode(300, seed=3).plan(420)
    shapes.append(("ragged M % 4 != 0", torch.randn(300, 4097, device=dev),
                   lt.indices[300:], lt.coeffs[300:]))
    idx = gen.integers(0, 200, (70, 9)).astype(np.int32)
    cof = gen.standard_normal((70, 9)).astype(np.float32)
    cof[gen.random((70, 9)) < 0.4] = 0.0
    cof[5] = 0.0
    shapes.append(("ragged zeros mid-row", torch.randn(200, 1030, device=dev), idx, cof))
    shapes.append(("ragged q = 1, d_max = 1", torch.randn(3, 4100, device=dev),
                   np.array([[2]], np.int32), np.array([[0.5]], np.float32)))
    idx = gen.integers(0, 500, (90, 200)).astype(np.int32)
    cof = gen.standard_normal((90, 200)).astype(np.float32)
    cof[gen.random((90, 200)) < 0.6] = 0.0
    shapes.append(("ragged heavy rows", torch.randn(500, 50_001, device=dev), idx, cof))
    for label, a, idx, cof in shapes:
        i_t = torch.as_tensor(idx, device=dev)
        c_t = torch.as_tensor(cof, device=dev)
        got = lt_encode_cuda(a, i_t, c_t)
        want = ref.ref_lt_encode(a, i_t, c_t)
        torch.cuda.synchronize()
        err, _ = max_err(torch, got, want)
        nnz = int(np.count_nonzero(cof))
        q, d_max = idx.shape
        row = {"phase": "kernel", "kernel": "lt_encode", "shape": label,
               "a": list(a.shape), "q": q, "d_max": d_max, "nonzeros": nnz,
               "max_degree": int((cof != 0).sum(1).max()),
               "max_abs_err": err, "tol": 0.0}  # the plain version's bits
        del got, want
        if label.startswith("task"):
            r, m = a.shape
            csr = _lt_csr(i_t, c_t, r)
            sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.cols.long(), csr.vals,
                                             size=(q, r), check_invariants=False)
            row["kernel_ms"], row["library_ms"], row["turns_ms"] = time_turns(
                torch, lambda: _lt_launch(a, csr), lambda: torch.sparse.mm(sparse, a), 3,
                warmup=1)
            row["library_call"] = "torch.sparse.mm(CSR generator [q, r], A), the same CSR"
            row["ms"] = time_ms(torch, lambda: lt_encode_cuda(a, i_t, c_t), 3, warmup=1)
            row["compaction_ms"] = time_ms(torch, lambda: _lt_csr(i_t, c_t, r), 3, warmup=1)
            row["compaction_share"] = row["compaction_ms"] / row["ms"]
            row["plain_ms"] = time_ms(torch, lambda: ref.ref_lt_encode(a, i_t, c_t), 2, warmup=1)
            # each input read once: the rows of A the table references, the
            # padded table; the output written once
            used_rows = int(torch.unique(csr.cols).numel())
            n_bytes = 4 * used_rows * m + 8 * q * d_max + 4 * q * m
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * nnz * m)
            row["a_rows_used"] = used_rows
            row["heavy_rows"] = csr.n_heavy
            # the same, had every nonzero entry to stream its row of A anew
            row["bound_no_reuse_ms"] = bound(n_bytes + 4 * (nnz - used_rows) * m, 0)[0]
            against_library(row, "kernel_ms")
            results.setdefault("lt_encode", {})["task"] = row
            del csr, sparse
        emit(row)
        check(err == 0.0, f"lt_encode {label}: {err} != 0 (the plain version's bits)")
        del a, i_t, c_t
        torch.cuda.empty_cache()
    lt_encode_cuda.launches = 0  # comparison launches are not the path's


def phase_task_gaussian(torch, args, results: dict, smi: str) -> None:
    """The task form with the Gaussian code at a stated cut, the reserve rows
    encoded by gaussian_encode on the card; then gaussian_encode at that
    call's shape."""
    from repro_torch.cluster import ec2_scenario
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda

    r_full, workers = ec2_scenario(2)
    r, m = r_full // 20, GAUSSIAN_TASK_M
    cut = {"r": r, "of_r": r_full, "m": m, "of_m": PAPER_M,
           "reason": "the host's static dense encode (numpy gather and einsum, "
                     "static rows x r x m multiply-adds, once in each of the two "
                     "runs): r/20 as benchmarks/paper_ec2.py, and m as wide as "
                     "keeps the phase within its share of the time limit"}
    emit({"phase": "cut", "task": "gaussian", **cut})
    a, x, y_ref = _task_inputs(torch, r, m, args.seed + 1)
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "gaussian", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran: the top-ups drew no reserve rows")
    host_row, host_res, _ = _run_task(torch, a, x, y_ref, workers, "gaussian", None,
                                      args.seed)
    row = {"phase": "task", "code": "gaussian", "scenario": 2, "r": r, "m": m,
           "cut": cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE,
           "device_encode": dev_row, "host_encode": host_row,
           "same_trajectory": _same_trajectory(dev_res, host_res),
           "y_max_abs_diff_device_vs_host": float(np.abs(dev_res.y - host_res.y).max()),
           "card": smi}
    emit(row)
    results["task_gaussian"] = row
    check(dev_res.ok and dev_row["max_rel_err"] <= 2e-3,
          f"Gaussian task rel err {dev_row['max_rel_err']}")
    check(dev_row["launches"]["gaussian_encode"] == 1,
          f"gaussian_encode launches {dev_row['launches']}")
    check(host_res.ok and host_row["max_rel_err"] <= 2e-3,
          f"Gaussian task (host encode) rel err {host_row['max_rel_err']}")
    check(row["same_trajectory"], "device and host encode runs differ in trajectory")

    # gaussian_encode at the task's shape: G [q, r] (the plan's reserve slice) x A
    dev = torch.device("cuda")
    g = torch.as_tensor(np.ascontiguousarray(enc["plan"].coeffs), device=dev)
    a_t = torch.as_tensor(a, device=dev)
    results.setdefault("gaussian_encode", {})["task"] = gaussian_row(
        torch, g, a_t, "task reserve slice", 20)
    gaussian_encode_cuda.launches = 0
    del g, a_t
    torch.cuda.empty_cache()


def phase_head(torch, params, cfg, gen) -> None:
    from repro_torch.models.transformer import _last_logits

    dev = torch.device("cuda")
    hidden = torch.randn(4, 1, cfg.d_model, device=dev, generator=gen)
    uncoded = hidden[:, -1] @ params["lm_head"]
    scale = float(uncoded.abs().max())
    for erased in ((), (0, 9)):
        mask = torch.ones(16, device=dev)
        mask[list(erased)] = 0.0
        got = _last_logits(params, hidden, cfg, mask, "cuda")
        torch.cuda.synchronize()
        rel = float((got - uncoded).abs().max()) / scale
        same_argmax = bool((got.argmax(-1) == uncoded.argmax(-1)).all())
        emit({"phase": "head", "arch": cfg.name, "w_coded": list(params["lm_head_coded"].shape),
              "erased": list(erased), "max_rel_err": rel, "tol": 1e-3,
              "argmax_equal": same_argmax})
        check(rel <= 1e-3, f"coded head erased={erased}: rel err {rel} > 1e-3")


def phase_serve(torch, args, results: dict, smi: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    full = get_config("glm4-9b")
    cfg = full.scaled(coded=True, coded_parity=2, n_layers=args.layers)
    if cfg.n_layers != full.n_layers:
        emit({"phase": "cut", "n_layers": cfg.n_layers, "of": full.n_layers})
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emit({"phase": "init", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "init_s": init_s,
          "param_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9})

    phase_head(torch, params, cfg, torch.Generator(device=dev).manual_seed(args.seed + 1))

    def latency_fn():  # three persistent stragglers: more than the budget of 2
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    def make_engine(engine_params, mesh=None):
        return ServeEngine(model, engine_params, n_slots=4, s_max=64, latency_fn=latency_fn,
                           parity_controller=ParityController(16, decay=0.5),
                           parity_topup=1, topup_patience=2,
                           head_kernel_mode="cuda", encode_mode="cuda", mesh=mesh, device=dev)

    eng = make_engine(params)
    head14 = params["lm_head_coded"]  # the (14, 2) head, for the mesh serve
    del params  # the engine keeps bf16 layer weights and the fp32 heads
    rng = np.random.default_rng(args.seed)
    n_req, prompt_len, max_new = 6, 16, 8
    prompts = [rng.integers(0, cfg.vocab, prompt_len) for _ in range(n_req)]
    for i, prompt in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new))

    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps, syncs = eng._steps, eng.sync_count

    n_tok = sum(len(r.out_tokens) for r in done)
    tokens = {r.uid: r.out_tokens for r in done}
    check(len(done) == n_req, f"{len(done)} of {n_req} requests completed")
    check(all(len(t) == max_new for t in tokens.values()), "a request missed its token count")
    check(all(0 <= t < cfg.vocab for ts in tokens.values() for t in ts), "token out of vocab")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"parity events {eng.parity_events}")
    check(eng.model.cfg.coded_parity == 3 and tuple(eng.params["lm_head_coded"].shape) == (16 * 11658, 4096),
          "head not re-split to (13, 3)")
    check(launches["gaussian_encode"] == 1, f"gaussian_encode launches {launches}")
    check(launches["coded_matvec_decode"] == n_req + steps,
          f"coded_matvec_decode launches {launches} != {n_req} prefills + {steps} steps")

    # times after the counted run.  The model's prefill call alone (B = 1,
    # no engine around it), by CUDA events; then whole engine steps.
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, prompt_len)), device=dev)
    prefill_call_ms = time_ms(torch, lambda: eng._prefill1(prompt), 5)
    step_ms = _timed_steps(torch, eng, rng, cfg.vocab, prompt_len)
    row = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "n_slots": 4,
           "s_max": 64, "requests": n_req, "prompt_len": prompt_len, "max_new": max_new,
           "tokens": n_tok, "decode_steps": steps, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "prefill_call_ms": prefill_call_ms,
           "step_ms": step_ms,
           "sync_count": syncs, "parity_events": eng.parity_events,
           "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "card": smi, "first_tokens": tokens[0]}
    emit(row)
    results["serve"] = row

    if args.profile:
        phase_profile(torch, eng)
    # the serve's params with the (14, 2) head, its engine factory, workload
    # and tokens, for the mesh phases
    return {"cfg": cfg, "params": dict(eng.params, lm_head_coded=head14),
            "make_engine": make_engine, "prompts": prompts, "max_new": max_new,
            "tokens": tokens, "rng": rng}


def _timed_steps(torch, eng, rng, vocab: int, prompt_len: int, n_timed: int = 5) -> float:
    """Mean ms of whole engine steps on a refilled queue, host clock: the
    first step admits every slot, each timed one decodes all of them
    (control plane, mask upload, model call, argmax and its host copy) and
    admits none."""
    from repro_torch.serve import Request

    for i in range(eng.n_slots):
        eng.submit(Request(uid=1000 + i, prompt=rng.integers(0, vocab, prompt_len),
                           max_new_tokens=32))
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        check(eng.step() == eng.n_slots, "a timed step did not decode every slot")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_timed


def _head_mesh(torch):
    """Sixteen logical devices on the one card: the glm4-9b head's mesh."""
    from repro_torch.sharding import HeadMesh

    dev = torch.device("cuda", 0)
    emit({"phase": "cut", "head_mesh": "16 logical devices on cuda:0",
          "of": "one card per code block (16 cards)",
          "reason": f"this machine has {torch.cuda.device_count()} card(s); the head "
                    "wants one device per code block, as the reference's tests put "
                    "16 logical devices on one host"})
    return HeadMesh((dev,) * 16)


def phase_mesh_head(torch, serve: dict, mesh, gen, results: dict, smi: str) -> None:
    """glm4-9b's coded head through coded_head_matvec(mesh=...) under 0, 1
    and 2 erasures: 16 coded_matvec launches a call, held to the uncoded
    head (rel 1e-3) and the fused head (1e-4 * max|y|); device time per
    call beside the fused head's."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import shard_coded_head

    dev = torch.device("cuda")
    cfg, params = serve["cfg"], serve["params"]
    wc = params["lm_head_coded"]
    placed = shard_coded_head(wc, mesh)
    check(all(b.untyped_storage().data_ptr() == wc.untyped_storage().data_ptr()
              for b in placed), "the placed head blocks are copies, not views")
    hidden = torch.randn(4, cfg.d_model, device=dev, generator=gen)
    x = hidden.T.contiguous()
    uncoded = hidden @ params["lm_head"]
    rows = []
    _reset_launches()
    for erased in ((), (5,), (5, 12)):
        mask = torch.ones(16, device=dev)
        mask[list(erased)] = 0.0
        got = ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh, kernel_mode="cuda")
        fused = ops.coded_head_matvec(wc, x, mask, 14, 2, kernel_mode="cuda")
        torch.cuda.synchronize()
        scale = float(uncoded.abs().max())
        rel = float((got[:cfg.vocab].T - uncoded).abs().max()) / scale
        vs_fused = float((got - fused).abs().max())
        tol_fused = 1e-4 * float(fused.abs().max())
        row = {"phase": "mesh_head", "arch": cfg.name, "w_coded": list(wc.shape),
               "block": list(placed[0].shape), "devices": len(mesh.devices),
               "erased": list(erased), "max_rel_err_vs_uncoded": rel, "tol": 1e-3,
               "max_abs_err_vs_fused": vs_fused, "tol_fused": tol_fused,
               "argmax_equal": bool((got[:cfg.vocab].T.argmax(-1) == uncoded.argmax(-1)).all())}
        rows.append(row)
        emit(row)
        check(rel <= 1e-3, f"mesh head erased={erased}: rel err {rel} > 1e-3")
        check(vs_fused <= tol_fused, f"mesh head erased={erased}: {vs_fused} > {tol_fused} "
                                     "against the fused head")
    launches = _launches()
    check(launches["coded_matvec"] == 16 * 3 and launches["coded_matvec_decode"] == 3,
          f"mesh head launches {launches}: want 16 coded_matvec a call")
    mask = torch.ones(16, device=dev)
    mask[[5, 12]] = 0.0
    mesh_ms = time_ms(torch, lambda: ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh,
                                                           kernel_mode="cuda"), 20)
    fused_ms = time_ms(torch, lambda: ops.coded_head_matvec(wc, x, mask, 14, 2,
                                                            kernel_mode="cuda"), 20)
    row = {"phase": "mesh_head_time", "b": 4, "erased": [5, 12], "mesh_ms": mesh_ms,
           "fused_ms": fused_ms, "launches": {"coded_matvec": launches["coded_matvec"]},
           "card": smi}
    emit(row)
    results["mesh_head"] = {"rows": rows, **row}


def phase_mesh_serve(torch, serve: dict, mesh, results: dict, smi: str) -> None:
    """ServeEngine(mesh=...) over the serve phase's params and workload: its
    greedy tokens must equal the single-device serve's, request for request,
    through the same (14, 2) -> (13, 3) raise, placed again on the mesh."""
    from repro_torch.serve import Request

    cfg, max_new = serve["cfg"], serve["max_new"]
    eng = serve["make_engine"](serve["params"], mesh)
    for i, prompt in enumerate(serve["prompts"]):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps = eng._steps
    tokens = {r.uid: r.out_tokens for r in done}
    n_tok = sum(len(t) for t in tokens.values())
    blocks = eng.params["lm_head_coded"]
    step_ms = _timed_steps(torch, eng, serve["rng"], cfg.vocab, len(serve["prompts"][0]))
    row = {"phase": "mesh_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "devices": len(mesh.devices), "requests": len(done), "tokens": n_tok,
           "decode_steps": steps, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "step_ms": step_ms, "parity_events": eng.parity_events, "launches": launches,
           "tokens_equal_single_device": tokens == serve["tokens"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
    emit(row)
    results["mesh_serve"] = row
    if tokens != serve["tokens"]:
        uid = min(u for u in serve["tokens"] if tokens.get(u) != serve["tokens"][u])
        want, got = serve["tokens"][uid], tokens.get(uid, [])
        k = next(i for i in range(len(want)) if i >= len(got) or got[i] != want[i])
        prefix = np.concatenate([serve["prompts"][uid], np.asarray(want[:k])])
        logits, _ = eng.model.prefill(
            eng.params, {"tokens": torch.as_tensor(prefix[None], device=eng.device)},
            head_mesh=mesh)
        top2 = torch.topk(logits[0], 2).values
        emit({"phase": "mesh_serve_mismatch", "uid": uid, "position": k,
              "single_device": want[k], "mesh": got[k] if k < len(got) else None,
              "top_two_logit_gap": float(top2[0] - top2[1])})
        check(False, f"mesh serve tokens differ from the single-device serve's (uid {uid})")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"mesh serve parity events {eng.parity_events}")
    check(isinstance(blocks, tuple) and len(blocks) == 16
          and all(tuple(b.shape) == (11658, cfg.d_model) for b in blocks),
          "the raised head was not placed again on the mesh")
    check(launches["coded_matvec"] == 16 * (len(done) + steps),
          f"coded_matvec launches {launches} != 16 x ({len(done)} prefills + {steps} steps)")
    check(launches["coded_matvec_decode"] == 0 and launches["gaussian_encode"] == 1,
          f"mesh serve launches {launches}")


MAMBA_PROMPTS = (4096, 4096, 1000, 1000, 100, 2)  # tokens of the six requests
MAMBA_S_MAX = 4104                                 # the longest prompt + 8 new tokens
# Prefill logits with the SSD kernels against the plain SSD on the card, of
# max|logit|, in float32 activations: each SSD output differs by ~1e-6 (fp32
# sums in another order), and 24-38 blocks grow that to ~1e-4; this bound
# holds the kernels through the depth.  The served bf16 path is held one
# block at a time (``_block0_ssd_inputs``): with bf16 activations a one-step
# rounding difference at block 0 sets the two runs apart, and the gap
# compounds with depth as bf16 noise does, so whole-model bf16 logits
# cannot tell a kernel fault from that noise.
PREFILL_F32_TOL = 1e-3
BF16_STEP = 2.0 ** -7   # one bf16 rounding step, relative to the value


def _block0_ssd_inputs(eng, prompt: dict) -> tuple:
    """The arguments block 0 hands ``kernels.ops.ssd_forward`` in the
    served model's own prefill of ``prompt`` (its activation dtype, the
    engine's params), recorded around one plain-SSD prefill."""
    from repro_torch.kernels import ops

    real, seen = ops.ssd_forward, []

    def record(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    ops.ssd_forward = record  # models.ssm imports it from ops at each call
    try:
        eng.model.prefill(eng.params, prompt, ssd_kernel_mode="off")
    finally:
        ops.ssd_forward = real
    return seen[0]


def phase_mamba_serve(torch, args, results: dict, smi: str, arch: str) -> None:
    """A Mamba-2 config (``ssm`` mamba2-130m or ``hybrid`` zamba2-1.2b) at
    full width and depth, seeded init on the card, coded head: 4 slots, six
    requests of 4096, 4096, 1000, 1000, 100 and 2 prompt tokens and 8 new
    tokens each, the three persistent stragglers forcing the (14, 2) ->
    (13, 3) raise.  Every Mamba block's prefill runs ssd_chunk and
    ssd_combine once; the launches are read around the run.  Then the
    prefill call's time per prompt length, whole engine steps, the
    last-position float32 prefill logits with the kernels against the same
    prefill with ssd_kernel_mode='off' on the card, and block 0's SSD of
    the served (bf16) prefill, kernels against plain."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(arch).scaled(coded=True, coded_parity=2)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_inner": cfg.d_inner, "ssd_heads": cfg.n_ssm_heads,
          "p": cfg.ssm_head_dim, "n": cfg.ssm_state, "chunk": cfg.ssm_chunk, "vocab": cfg.vocab,
          "init_s": time.perf_counter() - t0,
          "param_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9})

    def latency_fn():  # three persistent stragglers: more than the budget of 2
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    eng = ServeEngine(model, params, n_slots=4, s_max=MAMBA_S_MAX, latency_fn=latency_fn,
                      parity_controller=ParityController(16, decay=0.5), parity_topup=1,
                      topup_patience=2, head_kernel_mode="cuda", encode_mode="cuda",
                      ssd_kernel_mode="cuda", device=dev)
    del params
    rng = np.random.default_rng(args.seed + 14)
    max_new = 8
    for i, n_tok in enumerate(MAMBA_PROMPTS):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n_tok),
                           max_new_tokens=max_new))
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    steps, n_req = eng._steps, len(MAMBA_PROMPTS)
    tokens = {r.uid: r.out_tokens for r in done}
    n_tok = sum(len(t) for t in tokens.values())
    check(len(done) == n_req, f"{arch}: {len(done)} of {n_req} requests completed")
    check(all(len(t) == max_new for t in tokens.values()), f"{arch}: a request missed its count")
    check(all(0 <= t < cfg.vocab for ts in tokens.values() for t in ts), f"{arch}: token out of vocab")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"{arch}: parity events {eng.parity_events}")
    br13 = -(-cfg.vocab // 13)
    check(tuple(eng.params["lm_head_coded"].shape) == (16 * br13, cfg.d_model),
          f"{arch}: head not re-split to (13, 3)")
    want = cfg.n_layers * n_req
    check(launches["ssd_chunk"] == want and launches["ssd_combine"] == want,
          f"{arch}: SSD launches {launches}, want {want} of each ({cfg.n_layers} blocks x "
          f"{n_req} prefills)")
    check(launches["coded_matvec_decode"] == n_req + steps and launches["gaussian_encode"] == 1,
          f"{arch}: head launches {launches} ({n_req} prefills + {steps} steps, one raise)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # after the counted run: the prefill call (B = 1) per prompt length, by
    # CUDA events, then whole engine steps on a refilled queue
    prefill_ms = {}
    for length in sorted(set(MAMBA_PROMPTS), reverse=True):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, length)), device=dev)
        prefill_ms[length] = time_ms(torch, lambda: eng._prefill1(prompt), 3, warmup=1)
    step_ms = _timed_steps(torch, eng, rng, cfg.vocab, 100)

    # the prefill's last-position logits (a 1000-token prompt) with the SSD
    # kernels against the plain SSD on the card, in float32 activations
    # (same params)
    prompt = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, 1000)), device=dev)}
    m32 = build_model(dataclasses.replace(eng.model.cfg, dtype="float32"))
    got, plain = (m32.prefill(eng.params, prompt, ssd_kernel_mode=mode)[0]
                  for mode in ("cuda", "off"))
    torch.cuda.synchronize()
    logits = {"rel_err": float((got - plain).abs().max()) / float(plain.abs().max()),
              "tol": PREFILL_F32_TOL, "finite": bool(torch.isfinite(got).all()),
              "argmax_equal": bool((got.argmax(-1) == plain.argmax(-1)).all())}
    del m32, got, plain
    # the served path itself, at block 0: the SSD inputs of the served
    # model's prefill of the same prompt (padded to 1024, the model's own
    # dt·A), kernels against the plain route, each output within one bf16
    # step of its largest plain value
    args = _block0_ssd_inputs(eng, prompt)
    outs = [ops.ssd_forward(*args, mode=mode) for mode in ("cuda", "off")]
    torch.cuda.synchronize()
    block0 = {"dtype": str(args[0].dtype).removeprefix("torch."), "x": list(args[0].shape),
              "max_abs_cum": float(args[1].reshape(1, -1, cfg.ssm_chunk, args[1].shape[-1])
                                   .cumsum(2).abs().max())}
    for name, got, plain in zip(("y", "final"), *outs):
        scale = float(plain.float().abs().max())
        block0[name] = {"max_abs_err": float((got.float() - plain.float()).abs().max()),
                        "tol": BF16_STEP * scale, "max_abs_plain": scale,
                        "finite": bool(torch.isfinite(got).all())}
    del args, outs
    row = {"phase": "serve", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_slots": 4, "s_max": MAMBA_S_MAX, "requests": n_req, "prompt_lens": MAMBA_PROMPTS,
           "max_new": max_new, "tokens": n_tok, "decode_steps": steps, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "prefill_call_ms": prefill_ms, "step_ms": step_ms,
           "sync_count": eng.sync_count, "parity_events": eng.parity_events,
           "launches": launches, "peak_mem_gb": peak_gb,
           "f32_prefill_logits_vs_plain_ssd": logits, "block0_ssd_vs_plain": block0,
           "card": smi, "first_tokens": tokens[0]}
    emit(row)
    results[f"serve {arch}"] = row
    check(logits["finite"] and logits["rel_err"] <= logits["tol"],
          f"{arch}: float32 prefill logits with the SSD kernels differ from the plain SSD's "
          f"by {logits['rel_err']} of max|logit| (allowed {logits['tol']})")
    for name in ("y", "final"):
        r = block0[name]
        check(r["finite"] and r["max_abs_err"] <= r["tol"],
              f"{arch}: block 0's served ssd_forward {name}, kernels against plain: max err "
              f"{r['max_abs_err']}, allowed {r['tol']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_profile(torch, eng) -> None:
    """Device time by kernel over 3 whole engine steps, every slot decoding
    (torch.profiler), and the device's busy share of the window's wall
    time; both read with the profiler on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            check(eng.step() == eng.n_slots, "a profiled step did not decode every slot")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = [{"kernel": evt.key[:100], "device_ms_per_step": evt.self_device_time_total / 1e3 / steps,
             "launches_per_step": evt.count / steps}
            for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    busy = sum(r["device_ms_per_step"] for r in rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.json"), "w") as f:
        json.dump({"wall_ms_per_step": wall_ms, "device_ms_per_step": busy, "kernels": rows},
                  f, indent=1)
    emit({"phase": "profile", "wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
          "busy_share": busy / wall_ms if wall_ms else None,
          "launches_per_step": sum(r["launches_per_step"] for r in rows), "top": rows[:10]})


def _leaves(tree):
    """The tensors of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


LT_SWEEP = [(quads, rows, heavy) for quads in (1, 2, 4, 8)
            for rows, heavy in ((8, True), (16, True), (32, True), (16, False))]


def _lt_variants(settings) -> dict:
    """lt_encode.cu rebuilt with other span and chunk constants (kSpanQuads
    column quads a lane, kRowsPerChunk light rows a unit), one nvcc each,
    started together, under build/lt_sweep; {(quads, rows): its C entry}."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "lt_encode.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "lt_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for quads, rows in settings:
        text = src
        for name, value in (("kSpanQuads", quads), ("kRowsPerChunk", rows)):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            check(n == 1, f"lt_encode.cu defines {name} {n} times, not once")
        cu = out_dir / f"lt_encode_q{quads}_r{rows}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[(quads, rows)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    p = ctypes.c_void_p
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc of the lt_encode variant {key}:\n{log}")
        fn = ctypes.CDLL(str(lib)).lt_encode
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def sweep_lt(torch, args, smi: str) -> None:
    """lt_encode alone at the LT task's reserve slice (A [5,000, 500,000])
    for each span width (128 x 1, 2, 4, 8 columns), light rows per unit (8,
    16, 32) and with and without the heavy-row split (a CSR that marks no
    row heavy), each a variant of lt_encode.cu built here, timed in turns
    with torch.sparse.mm on the same CSR and held to the plain version's
    bits; one JSON line.  The table is the task's own (scenario 1, this
    seed): the task runs in model time, so its trajectory does not depend
    on m and a run at m = 8 on the CPU gives it."""
    from repro_torch.cluster import ClusterEmulator, TaskSpec, ec2_scenario
    from repro_torch.core.adaptive import ReallocationPolicy
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import _lt_csr

    t0 = time.perf_counter()
    variants = _lt_variants(sorted({(quads, rows) for quads, rows, _ in LT_SWEEP}))
    build_s = time.perf_counter() - t0
    r, workers = ec2_scenario(1)
    rng = np.random.default_rng(args.seed)
    em = ClusterEmulator(workers, time_scale=1e-3, seed=args.seed, device="cpu")
    em.run_task(rng.standard_normal((r, 8)).astype(np.float32),
                rng.standard_normal(8).astype(np.float32),
                TaskSpec(scheme="bpcc", code="lt", adaptive=ReallocationPolicy(),
                         churn=_churn(r), encode_mode="device"))
    plan = em.last_encode["plan"]
    dev = torch.device("cuda")
    a = torch.randn(r, PAPER_M, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(args.seed))
    i_t = torch.as_tensor(plan.indices, device=dev)
    c_t = torch.as_tensor(plan.coeffs, device=dev)
    q, m = i_t.shape[0], PAPER_M
    want = ref.ref_lt_encode(a, i_t, c_t)
    csr = _lt_csr(i_t, c_t, r)
    sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.cols.long(), csr.vals, size=(q, r),
                                     check_invariants=False)
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for quads, rows, heavy in LT_SWEEP:
        fn, c = variants[(quads, rows)], csr if heavy else csr._replace(n_heavy=0)
        out = torch.empty(q, m, device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)

        def launch():
            counter.zero_()
            err = fn(a.data_ptr(), c.row_ptr.data_ptr(), c.cols.data_ptr(), c.vals.data_ptr(),
                     c.order.data_ptr(), out.data_ptr(), q, m, c.n_heavy, counter.data_ptr(),
                     stream)
            check(err == 0, f"lt_encode variant ({quads}, {rows}): cudaError {err}")

        launch()
        torch.cuda.synchronize()
        exact = torch.equal(out, want)
        kernel_ms, library_ms, turns = time_turns(
            torch, launch, lambda: torch.sparse.mm(sparse, a), 3, warmup=1)
        runs.append({"span": 128 * quads, "rows_per_chunk": rows, "heavy_split": heavy,
                     "kernel_ms": kernel_ms, "library_ms": library_ms,
                     "ratio": kernel_ms / library_ms, "turns_ms": turns, "bit_equal": exact})
        check(exact, f"lt_encode span {128 * quads}, {rows} rows, heavy {heavy}: "
                     "not the plain version's bits")
        del out
    emit({"phase": "sweep lt", "q": q, "r": r, "m": m, "nonzeros": int(csr.cols.numel()),
          "heavy_rows": csr.n_heavy, "max_degree": int((c_t != 0).sum(1).max()),
          "variant_build_s": build_s, "card": smi, "runs": runs})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth to serve (40 = full; widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over 3 engine steps")
    ap.add_argument("--sweep-lt", action="store_true",
                    help="only build, check the encode kernels and sweep lt_encode's "
                         "span width, light rows a unit and heavy split at the LT task's "
                         "shape (no serve, no device line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (pins fp32 matmul precision)

    torch.cuda.set_device(0)
    smi = phase_device(torch)
    results: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.sweep_lt:
        kernel_gaussian(torch, gen, results)
        gaussian_row(torch, torch.randn(26, 500, device="cuda", generator=gen),
                     torch.randn(500, GAUSSIAN_TASK_M, device="cuda", generator=gen),
                     "task shape, random G", 20)
        sweep_lt(torch, args, smi)
        return 0
    phase_kernels(torch, gen, results)
    phase_task_lt(torch, args, results, smi)
    phase_task_gaussian(torch, args, results, smi)
    serve = phase_serve(torch, args, results, smi)
    mesh = _head_mesh(torch)
    phase_mesh_head(torch, serve, mesh, torch.Generator(device="cuda").manual_seed(args.seed + 2),
                    results, smi)
    phase_mesh_serve(torch, serve, mesh, results, smi)
    del serve, mesh
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SSD_WIDTHS:
        phase_mamba_serve(torch, args, results, smi, arch)

    kernels = []
    for name, source, replaces, path, phase, shape in (
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "serve", results["serve"], "glm4-9b decode"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "serve", results["serve"], "glm4-9b raise"),
        ("lt_encode", "src/repro_torch/kernels/csrc/lt_encode.cu",
         "src/repro/kernels/lt_encode.py:61", "task lt", results["task_lt"], "task"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "task gaussian", results["task_gaussian"],
         "task"),
        ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
         "src/repro/kernels/coded_matvec.py:47", "mesh head", results["mesh_head"],
         "glm4-9b block decode"),
        ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
         "src/repro/kernels/coded_matvec.py:47", "mesh serve", results["mesh_serve"],
         "glm4-9b block decode"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "mesh serve", results["mesh_serve"],
         "glm4-9b raise"),
        *((name, src, replaces, f"{fam} serve", results[f"serve {arch}"], shape)
          for arch, fam in (("mamba2-130m", "ssm"), ("zamba2-1.2b", "hybrid"))
          for name, src, replaces, shape in (
              ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:52", f"{arch} {SSD_TIMED} bfloat16"),
              ("ssd_combine", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:99", f"{arch} {SSD_TIMED} bfloat16"),
              ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", f"{arch} decode"),
              ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
               "src/repro/kernels/lt_encode.py:107", f"{arch} raise"))),
    ):
        r = results[name][shape]
        launches = phase.get("device_encode", phase)["launches"]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": r["max_abs_err"],
                 "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"], "path": path, "shape": r["shape"]}
        if "kernel_ms" in r:  # lt_encode: ms is the call; kernel_ms the kernel alone
            entry["kernel_ms"] = r["kernel_ms"]
        if "cut" in phase:  # the task phases: the cut of r and m, or None
            entry.update(r=phase["r"], m=phase["m"], cut=phase["cut"])
        kernels.append(entry)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "results": results, "kernels": kernels}, f, indent=1)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
