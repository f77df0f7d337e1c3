#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # as run on the card; needs one GPU
    python3 chip_smoke.py --profile    # also a torch.profiler window over engine steps
    python3 chip_smoke.py --sweep-lt   # only: build, the encode kernels' checks, and
                                       # lt_encode's two engines: the L2 engine's spans
                                       # at the whole LT plan, the slab engine's widths
                                       # at the EC2 example's shape (variants of
                                       # lt_encode.cu built under build/lt_sweep)
    python3 chip_smoke.py --sweep-gauss
                                       # only: build, the encode kernels' checks, and
                                       # gaussian_encode's register and tensor-core
                                       # engines at q = 16 to 564 (r 500, m 500,000) in
                                       # turns with torch.matmul (GAUSSIAN_WIDE_MIN_Q)
    python3 chip_smoke.py --sweep-ssd  # only: build, the SSD kernels' checks, and
                                       # ssd_scan.cu's tensor-core settings at the
                                       # 4096- and 1000-token Mamba-2 cells, in turns
                                       # with the SIMT kernels (variants built under
                                       # build/ssd_sweep)
    python3 chip_smoke.py --c2-order   # only: build, the vlm, moe and encdec serves, then
                                       # the glm4-9b train phase, with the allocator's
                                       # state (an out-of-memory error's statistics and
                                       # snapshot under chiprun_out/); no device line
    python3 chip_smoke.py --sweep-wide # only: build, the head kernels' checks, and the
                                       # thin-row (a copy built under build/head_sweep
                                       # with kMaxB 16) against the wide engine at B = 4
                                       # to 17 on the glm4-9b block and W_c and the
                                       # mamba2-130m W_c (the threshold WIDE_MIN_B)
    python3 chip_smoke.py --prefill-attn
                                       # only: build, the prefill attention kernel's
                                       # checks and timings at glm4-9b's heads, and a
                                       # longprompt-shaped glm4-9b serve through the
                                       # kernel and through the plain path
    python3 chip_smoke.py --sweep-head # only: build, the head kernels' checks, the
                                       # B = 1 heads in 30 pairs of turns with
                                       # torch.matmul, and thin_rows.cuh's settings at
                                       # the glm4-9b and Mamba-2 heads' shapes
                                       # (variants built under build/head_sweep)

A kernel that has a library call computing the same function is timed in
turns with it on the one card (kernel, library, library, kernel); its row
prints ms, library_ms, their ratio, bound_ms and the share of the bound.

Phases, one JSON line each; any failure exits non-zero before the last line:

1. device: name, ``nvidia-smi`` name and power limit, kernel build seconds
   (one ``nvcc`` per source, started together);
2. kernels: the serving kernels against their plain PyTorch versions on the
   card, at the serving path's shapes (the glm4-9b, mamba2-130m and
   zamba2-1.2b, llama-3.2-vision-11b and dbrx-132b heads at B = 1 and B = 4
   (dbrx's x in panels at B = 4), the (13, 3) parity re-encodes,
   the mesh head's [10826, 4096] code block at B = 1 and 4, each head
   kernel launched twice and held to its own bits; ``ssd_chunk`` and
   ``ssd_combine`` at both Mamba-2 widths for prompts of 4096, 1000 (padded
   to 1024), 100 and 2 tokens in bf16 and fp32, under the reference tests'
   decay and a slow one that keeps every tile in sight, a cell whose exp
   overflows above the diagonal, and ``ssd_forward`` with h0) and at
   ragged, fp16 and misaligned shapes; the head kernels at B > 16 (x in
   column panels of at most 16, one launch a panel: B1 at the glm4-9b code
   block and B2 at the mamba2-130m head at B = 17, 33 and 128, B2 at the
   glm4-9b head at B = 8) and the SSD kernels at the dryrun phase's cells
   (zamba2-1.2b's 32,768-token prefill, mamba2-130m's 8 x 4,096 train step);
   max error against the stated tolerance, kernel / plain / library times and
   the bound;
3. task, LT: the paper's coded task form (§5.1 scenario 1: r = 5,000, five
   EC2 workers, m = 500,000) through ``ClusterEmulator.run_task`` — Algorithm
   1, all of Â (the static rows and the reserve) LT-encoded on the card in
   one ``lt_encode`` launch by ``TaskSpec``'s default ``encode_mode``
   ('device': the card), adaptive top-ups under churn (worker 0 dies,
   worker 1 slows 5x), the streaming peeling decode — held to A·x in
   float64, with the seconds of the encode's copy in, kernel and copy out;
   then a pair of runs at a narrower m (50,000, printed as a cut), one with
   the device encode and one with the host encode, on the same seed: the
   same trajectory and ``t_complete``, and the host encode's y held to A·x;
   then ``lt_encode`` against its plain version, bit for bit (the wrapper,
   ``encode_rows``' host CSR and each engine that takes the table), at the
   full run's shapes (the whole plan, and its reserve slice: both on the L2
   engine, their tables too large for a slab) and at ragged ones (on the
   slab engine): at the task's shapes each engine's kernel alone on the CSR
   that ``torch.sparse.mm`` also gets (``kernel_ms``, device time in turns
   with it), the call as ``run_task`` makes it (``ms``), the host CSR's
   build and copy (``host_csr_ms``) and the compaction on the card
   (``compaction_ms``).  m is cut only if host memory is short, and the cut
   is printed; the seconds of the inputs, the full run and the pair are
   printed;
4. task, Gaussian: the same at r = 500 (scenario 2's r/20, ten workers,
   printed as a cut) and the paper's m = 500,000, ``code="gaussian"``, all
   of Â encoded by one ``gaussian_encode`` (q = 564: the tensor-core
   engine), its trajectory pair at m = 20,000; ``gaussian_encode`` at the
   whole plan and its reserve slice on both engines, each timed in turns
   with torch.matmul and held to float64; then the paper's EC2 experiments
   1 and 2 (Figs 8, 10) through the port's entry point
   ``examples/ec2_repro_torch.py`` at r/40 and two trials a cell, the
   master's encode on the card: every task decodes, one ``lt_encode``
   launch a coded task, each on the slab engine (its tables printed), every
   coded task's table held to the plain version's bits, the last timed on
   both engines; within a budget of 60 s;
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
8. trace serve: glm4-9b on the serve phase's params with the (14, 2) head,
   driven as the launcher's trace mode drives it (wall clock, a sleep to the
   next arrival): a Poisson trace of 12 requests of 16 prompt tokens and up
   to 64 new tokens at about 70 % offered load (``t_token_est`` the serve
   phase's step time, SLO factor 4), 4 slots, a ``HealthMonitor``-fed
   latency stream with the three persistent stragglers, ``ParityController``
   under ``DeadlineAwareParity``, one raise allowed, ``macro_steps=16``;
   every request completes or is rejected at admission, completed ones with
   their token budget, exactly one raise, at least one fused block (a graph
   replay) under the scheduler's gates;
9. macro serve, glm4-9b: the same params, 4 slots, four requests of 16
   prompt tokens and 64 new tokens under a fixed mask of two erasures, with
   ``macro_steps=1`` and then 16 (fused blocks as CUDA graphs, one per K
   bucket), three waves of the same prompts: equal tokens and
   ``coded_matvec_decode`` launches = prefills + steps + one warm-up step a
   capture in every wave (a replay counts its graph's kernel nodes); the
   third wave, on warm engines, captures nothing and is timed: ms per
   decoded step, host syncs per token, fused blocks, capture seconds per
   bucket, the graph pool's bytes, the 16-step graph's device time, and the
   step's byte bound and share;
9b. macro serve, svd: fused blocks whose head decodes through
   ``svd_recovery``, its recovery matrix built in the graphs by the
   ``masked_pinv`` kernel.  ``masked_pinv`` against its plain version
   (float64 ``torch.linalg.pinv``) on every mask of at most 6 erasures at
   (10, 6) (14,893) and of at most 2 at (14, 2), and 64 masks of one
   erasure more each, in one launch: each mask within 1e-6 of its own
   max|rec|, erased columns zero,
   relaunches and single-mask calls bit-equal; at the served mask timed in
   turns with ``torch.linalg.pinv`` (a yardstick), its device time in a
   graph, its host time and its bound.  The serve phase's head re-encoded
   on the card into (10, 6) (``gaussian_encode``, checked and timed), its
   decode at B = 4 under six erasures checked and timed; then phase 9's
   macro pair with 16 new tokens for the (10, 6) head under six fixed
   erasures and for the (14, 2) head with ``head_kernel_mode='svd'``:
   equal tokens, ``coded_matvec_decode`` and ``masked_pinv`` each launched
   once a head call; the phase's seconds held to a budget of 60 s;
10. auto glm4-9b: ``kernel_mode='auto'`` through the committed dispatch
   table (``reports/bench/cuda/autotune.json``, checked: measured on an
   H100, every winner a kernel within the cost model's error bound) on the
   serve phase's params: the coded head at B = 1 and 4 under 0 and 2
   erasures, bit-equal to the default and to the explicit mode of its
   decision (printed: source, impl, predicted and measured µs) and within
   1e-3 x max|y| of the plain version; the mesh head bit-equal to the
   default; the serve phase's requests with ``head_kernel_mode`` and
   ``encode_mode`` 'auto' (tokens equal the serve phase's, launches =
   prefills + steps, one raise); a macro pair under 'auto' (four requests
   of 16 + 32 tokens, equal tokens); ``gaussian_encode`` at the glm4-9b
   raise and ``lt_encode`` at the LT task's reserve on A seeded on the
   card, each bit-equal to 'cuda'; a budget of 120 s;
11. ssm serve and hybrid serve: mamba2-130m and zamba2-1.2b at full width
   and depth (seeded init on the card), coded head, 4 slots, six requests of
   4096, 4096, 1000, 1000, 100 and 2 prompt tokens and 8 new tokens, the
   same three stragglers forcing the raise; every Mamba block's prefill runs
   ``ssd_chunk`` and ``ssd_combine`` (24 x 6 and 38 x 6 launches); prefill
   ms per prompt length, whole-step ms, tokens/s, peak memory, the float32
   prefill logits with the SSD kernels against the plain SSD on the card,
   and block 0's SSD of the served bf16 prefill against its plain route;
   then the macro pair of phase 9 on the same engine factory, four requests
   of 100 prompt tokens and 64 new tokens;
12. vlm serve: llama-3.2-vision-11b whole (40 layers, 8 with tanh-gated image
   cross-attention, every gate set to 0.5: at init tanh(0) = 0 hides them),
   coded head (14, 2) = W_c [146592, 4096], seeded init on the card, 4
   slots, six requests of 8192, 1000, 100, 16, 16 and 16 prompt tokens with
   a seeded image [1024, 4096] each and 8 new tokens, the three stragglers
   forcing the (13, 3) raise (``gaussian_encode`` at A [13, 9866 x 4096]);
   the 8192-token prompt runs ``_sdpa_chunked`` in all 40 self-attentions
   and 8 cross-attentions (counted), and block 0's call is held to the
   dense ``_sdpa`` on the same q, k, v; the coded head under 0 and 2
   erasures within 1e-3 of the uncoded head; prefill ms per prompt length,
   step ms, tokens/s, peak GB; then the macro pair of phase 9 (four
   requests of 16 + 64 tokens, scalar against fused, equal tokens);
13. moe serve: dbrx-132b at full width (d 6144, 48/8 heads, 16 experts
   top-4, d_ff 10752), depth cut to 3 of 40 layers (printed as a cut),
   coded head (14, 2) = W_c [114688, 6144] (x in panels at B = 4), raised
   to (13, 3) = [123520, 6144]; the same mix without the 8192-token prompt;
   the share of (token, k) assignments dropped by capacity at prefill and
   at decode (B = 4: T = 4, cap = 2); block 0's ``moe_apply`` against its
   per-token loop (``moe_apply_loop``, the same keep mask) at the 100-token
   prefill and a B = 4 decode; times and the macro pair as in phase 12;
14. encdec serve: seamless-m4t-large-v2 whole (24 + 24 layers) through the
   engine as the reference serves it, zero frames and the uncoded head: no
   TPU kernel on this path, and none may launch; then a prefill and a
   decode step from seeded frames, the decode within 0.05 of max|logit| of
   ``encdec_forward`` at the next position;
15. dryrun: ``python -m repro_torch.launch.dryrun --dry-run --multi-pod
   both``'s listing; the reckoned rows (both meshes, HW_H100) of four cells
   at their assigned workload, glm4-9b decode_32k coded, mamba2-130m
   decode_32k coded, zamba2-1.2b prefill_32k and mamba2-130m train_4k; then
   each cell's function (``build_cell``) on the card, its arguments made
   there, seeded, at the shapes reckoned with the batch cut where memory
   needs it (128 -> 8, none, 32 -> 1, 256 -> 8; printed as cuts): argument
   bytes equal to the 1 x 1 mesh's reckoning, peak allocated, the median of
   3 timed steps beside the roofline's bound (share printed, no limit), the
   kernels launched (B2 at 8 and at 128 columns, B5 and B6), a finite output
   of the expected shape, and a decode cell's coded head within 1e-3 of
   max|logit| of the plain head;
16. train glm4-9b: full width, depth cut to 2 layers (printed as a cut),
   bf16 activations, fp32 params and moments, batch 8 of 512 tokens in 4
   microbatches: from one seeded state the FRC (s = 1) step under an
   all-ones and a one-straggler mask gives the plain step's loss (1e-5
   relative) and gradient (1e-4 of each leaf's max, read by the step's
   ``gradients``), and under an undecodable mask leaves params and optimizer state
   bit-equal; the loss along AdamW's first update in fp32 activations (the
   whole update, the head's part and the rest, at steps 1e-5 to 3e-3), with
   the gradient held to a central difference of the loss along it (1e-2
   relative); then 10 plain and 10 FRC steps, timed (step ms, tokens/s,
   peak GB), one profiled (device busy share); the loss must go down;
17. train zamba2-1.2b: 18 of 38 layers, batch 8 of 1024 tokens (4 SSD
   chunks a block) in 4 microbatches: the cyclic (s = 1) step against the
   plain step as in phase 16 (two stragglers undecodable); through
   ``repro_torch.launch.train`` a 3-step run with adaptive s, then the timed
   run at a fixed s = 1 with int8 messages and error feedback under Markov
   stragglers at 0.2 and 3x; ``ssd_chunk`` and ``ssd_combine`` launch once per Mamba
   block per forward and per checkpoint recompute; at block 0's real SSD
   inputs the kernels against their plain versions (timed), ``SSDScan``'s
   forward bit-equal to the kernels' and its gradients within 1e-5 of
   autograd through ``ssd_chunked``, its recompute's share of a step; every
   kernel wrapper refuses an input that requires grad; one step of the timed
   configuration profiled;
18. train drill: mamba2-130m through the launcher on 8 logical devices
   (2 DP slices), FRC s = 0, 10 steps, a checkpoint every 3 steps, the last
   slice killed at step 7: 2 skipped steps, the grid shrinks 2 -> 1, the run
   resumes from step 6, and (under deterministic algorithms) its losses
   after the restore equal a fresh run's from that checkpoint bit for bit;
   then the SSD kernels and ``SSDScan`` at its block 0 as in phase 17;
19.-21. train llama-3.2-vision-11b (depth cut to one group of 5 of 40
   layers: four self-attention layers and the gated cross-attention layer,
   gates 0.5, seeded images [8, 1024, 4096]), dbrx-132b (1 of 40 layers,
   16 experts top-4, one microbatch, plain steps only) and
   seamless-m4t-large-v2 (12 + 12 of its 24 + 24 layers, seeded frames
   [8, 512, 1024]): full width, bf16 activations, fp32 params, int8 moments, batch
   8 of 512 tokens (4 microbatches for the vlm and the encdec), the cut
   printed; the plain step's gradient at the seeded state, with the
   family's own leaves (the cross-attention's gate and weights, the
   router, the encdec's cross-attention and first encoder weights)
   non-zero and finite, the loss, the aux loss and the share of MoE
   assignments dropped at capacity; for the vlm and the encdec the FRC
   (s = 1) step against the plain one as in phase 16; then 4 plain and 4
   FRC steps on two batches in turn, timed (step ms, tokens/s, peak GB
   beside the memory reckoned beforehand), one profiled (device busy
   share); the loss must go down, and none of the six kernels may launch;
22. a ``kernels`` line with every kernel on every path it runs (launch
   counts read around that path's run; ``engine`` the engine of the timed
   row, ``wide_launches`` and ``slab_launches`` the second engine's
   launches: every engine of the six kernels appears; ``lt_encode``'s
   ``ms`` is the call with its host CSR, its ``kernel_ms`` the kernel
   alone, which its ``library_ms`` is held to), then the device line.  The
   seconds of each phase are printed before it.

It imports nothing of JAX, and exits non-zero without CUDA or without the
repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
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
TC_BF16_FLOPS = 989e12       # H100 SXM dense bf16 on the tensor cores (data sheet)
FP64_FLOPS = 67e12           # H100 SXM float64 on the tensor cores (DMMA; data sheet)
SPLIT_PRODUCTS = 6           # the wide head engine's bf16 products an fp32 one (wide_rows.cuh)
WIDE_ERR_VS_MATMUL = 2.0     # its error against float64, at most this times fp32 torch.matmul's
PAPER_M = 500_000            # the paper's width of A (benchmarks/paper_ec2.py)
TASK_TIME_SCALE = 10.0       # wall seconds per model second of the paced task runs
# the task forms' trajectory pair (device encode against host encode) runs at
# a tenth of the full width: the host's encode scales with m, and the task
# runs in model time, so the pair's width does not change what it checks
LT_PAIR_M = 50_000
GAUSSIAN_PAIR_M = 20_000
PAIR_REASON = ("the host encode's run exists only for the trajectory check (device vs host "
               "encode, one seed), whose outcome does not depend on m; at the full width the "
               "host's numpy encode of all of A-hat alone takes minutes of the smoke's 1,200 s "
               "limit")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS) -> tuple[float, str]:
    """Least time (ms) the card could take, and what sets it: bytes at the
    memory's rate, operations at ``flops`` (fp32 outside the tensor cores
    unless named)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops
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


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host time (ms) of one call of ``fn``, over ``calls`` back-to-back
    calls with no sync between them (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return t


def head_host_cost(torch, row: dict, wrapper, source: str, w, x, rec, iters: int) -> None:
    """What the wrapper adds to a head kernel's launch: the wrapper's calls
    and the bare C entry's (on the wrapper's plan) timed in turns on the
    device, and each one's host time a call (``host_ms``)."""
    from repro_torch.kernels import _build, thin_rows

    direct, _, _ = _head_launch(
        torch, _build.load(source),
        (thin_rows.WARPS, thin_rows.ROWS_PER_WARP, thin_rows.BLOCKS_PER_SM), w, x, rec)
    row["wrapper_ms"], row["direct_ms"], _ = time_turns(torch, wrapper, direct, iters)
    row["host_ms_wrapper"] = host_ms(torch, wrapper)
    row["host_ms_direct"] = host_ms(torch, direct)


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
    hmma = sass_count(_build.load("ssd_scan")._name, "HMMA")
    ssd_ptxas = _ptxas_summary(_build.ptxas_report("ssd_scan"))
    emit({"phase": "device", "torch_device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
          "build_s": build_s, "nvcc_parallel_s": nvcc_s, "ptxas": ptxas,
          "ssd_scan_hmma": hmma, "ssd_scan_ptxas": ssd_ptxas})
    check(hmma > 0, "ssd_scan's library holds no HMMA: the bf16 route is off the tensor cores")
    check(ssd_ptxas["spill_bytes"] == 0, f"ssd_scan spills: {ssd_ptxas}")
    return smi


def sass_count(lib: str, opcode: str) -> int:
    """How many instructions of ``opcode`` a built library's SASS holds
    (``cuobjdump --dump-sass``, from nvcc's toolkit)."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def phase_kernels(torch, gen, results: dict) -> None:
    kernel_coded_decode(torch, gen, results)
    kernel_gaussian(torch, gen, results)
    kernel_coded_matvec(torch, gen, results)
    kernel_ssd(torch, results)
    kernel_ssd_dryrun(torch, results)
    kernel_prefill_attn(torch, results)
    # launches made for these comparisons are not the main path's
    _reset_launches()


PREFILL_CHECKED = (1, 65, 1000, 4160)        # prompt lengths held to the plain version
PREFILL_TIMED = (256, 1024, 2048, 4096)       # glm4-9b prompt lengths timed
PREFILL_SERVE = (512, 1024, 2048, 4096, 700, 1500)  # a longprompt-shaped serve's prompts
PREFILL_REPLACES = "none: the reference's attention is plain jnp (src/repro/models/attention.py)"


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so the host's cost a call (a
    wrapper's checks and allocations) is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_prefill_attn(torch, results: dict) -> None:
    """The serving prefill's attention kernel (``prefill_attn_cuda``: the
    prologue and the attention) against its plain version at glm4-9b's heads
    (32 over 2 KV heads, Hd 128) and zamba2-1.2b's (32 over 32, Hd 64) at
    ``PREFILL_CHECKED`` tokens: cache rows bit-equal, the output's error
    against an fp32 SDPA of the same roped inputs within the plain bf16
    SDPA's and one rounding of the output (tests/test_torch_cuda.py).  Then
    timed at glm4-9b's heads at ``PREFILL_TIMED`` tokens, device time from
    CUDA-graph replays in turns with torch's SDPA (``library_ms``; the port
    never calls it), beside the eager chain the kernel replaced (the cache
    K roped by ``apply_rope``, Q and K roped again, each rope rebuilding its
    table, the cache writes and the plain bf16 SDPA: ``plain_ms``, the
    projections left out of both), the wrapper's host time a call and the
    bound (the causal QK^T and PV at 989 TFLOP/s, or Q, K, V and O once)."""
    import torch.nn.functional as F

    from repro_torch.kernels.prefill_attn import prefill_attn_cuda
    from repro_torch.models.attention import _attention_prefill_plain, _causal_mask5, _sdpa
    from repro_torch.models.layers import apply_rope, apply_rope_table, rope_table

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    theta = 5e5

    def inputs(s, h, kvh, hd):
        q, k, v = (torch.randn(1, s, n, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for n in (h, kvh, kvh))
        return q, k, v, rope_table(torch.arange(s, device=dev)[None], hd, theta)

    for h, kvh, hd in ((32, 2, 128), (32, 32, 64)):
        for s in PREFILL_CHECKED:
            q, k, v, rope = inputs(s, h, kvh, hd)
            cache = torch.zeros((4, 1, s, kvh, hd), dtype=torch.bfloat16, device=dev)
            with torch.no_grad():
                got = prefill_attn_cuda(q, k, v, *rope, cache[0], cache[1])
                plain = _attention_prefill_plain(q, k, v, rope, cache[2], cache[3])
                ref = _sdpa(apply_rope_table(q, *rope).float(), apply_rope_table(k, *rope).float(),
                            v.float(), _causal_mask5(s, s, dev))
            torch.cuda.synchronize()
            err, ref_max = max_err(torch, got.float(), ref)
            plain_err, _ = max_err(torch, plain.float(), ref)
            check(torch.equal(cache[0], cache[2]) and torch.equal(cache[1], cache[3]),
                  f"prefill_attn's cache rows differ from the plain version's at S={s}, Hd {hd}")
            check(err <= plain_err + 2.0 ** -9 * ref_max,
                  f"prefill_attn's error {err} over the plain SDPA's {plain_err} at S={s}, Hd {hd}")
            emit({"phase": "kernel check", "kernel": "prefill_attn", "s": s, "heads": h,
                  "kv_heads": kvh, "head_dim": hd, "max_abs_err": err, "plain_err": plain_err,
                  "ref_max": ref_max})
    h, kvh, hd = 32, 2, 128
    for s in PREFILL_TIMED:
        q, k, v, rope = inputs(s, h, kvh, hd)
        positions = torch.arange(s, device=dev)[None]
        cache = torch.zeros((2, 1, s, kvh, hd), dtype=torch.bfloat16, device=dev)
        qr, kr = apply_rope_table(q, *rope), apply_rope_table(k, *rope)
        qt, kt, vt = qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2)

        def kernel():
            return prefill_attn_cuda(q, k, v, *rope, cache[0], cache[1])

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        def eager():
            cache[0].copy_(apply_rope(k, positions, theta))
            cache[1].copy_(v)
            return _sdpa(apply_rope(q, positions, theta), apply_rope(k, positions, theta), v,
                         _causal_mask5(s, s, dev))

        iters = 20 if s >= 2048 else 50
        with torch.no_grad():
            turns = [graph_ms(torch, fn, iters) for fn in (kernel, library, library, kernel)]
            plain_ms = time_ms(torch, eager, 5)
            host = host_ms(torch, kernel, 100)
            err, _ = max_err(torch, kernel().float(), library().transpose(1, 2).float())
        n_ops = 4 * hd * h * s * (s + 1) / 2
        n_bytes = 2 * (2 * s * h * hd + 2 * s * kvh * hd)
        bound_ms, bound_by = bound(n_bytes, n_ops, TC_BF16_FLOPS)
        label = f"glm4-9b S={s}"
        row = against_library({
            "phase": "kernel", "kernel": "prefill_attn", "shape": label,
            "ms": (turns[0] + turns[3]) / 2, "library_ms": (turns[1] + turns[2]) / 2,
            "turns": turns, "plain_ms": plain_ms, "host_ms": host, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err})
        emit(row)
        results.setdefault("prefill_attn", {})[label] = row


def phase_prefill_serve(torch, args, results: dict, smi: str) -> None:
    """A longprompt-shaped glm4-9b serve (``PREFILL_SERVE`` prompts, 8 new
    tokens each) at full width and ``args.layers`` layers, traced, through
    the prefill kernel and then, on the same engine, through the plain path
    (the route forced): launches a layer and prompt, equal tokens, and each
    route's host milliseconds a ``model.attn`` span under ``engine.prefill``
    by ``path``."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, transformer
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.utils.trace import Tracer

    dev = torch.device("cuda")
    cfg = get_config("glm4-9b").scaled(coded=True, coded_parity=2, n_layers=args.layers)
    model = build_model(cfg)
    tracer = Tracer()
    eng = ServeEngine(model, model.init(torch.Generator(device=dev).manual_seed(args.seed), dev),
                      n_slots=4, s_max=4160, device=dev, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PREFILL_SERVE]
    row = {"phase": "prefill serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "prompts": list(PREFILL_SERVE), "card": smi}
    tokens = {}
    real_path = attention.prefill_path
    for r, route in enumerate(("kernel", "plain")):
        # the route and the spans' path attribute, both forced on the plain route
        attention.prefill_path = transformer.prefill_path = (
            real_path if route == "kernel" else (lambda x, hd: "plain"))
        try:
            n_spans, n_done = len(tracer.spans), len(eng.completed)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=r * len(prompts) + i, prompt=p, max_new_tokens=8))
            _reset_launches()
            t0 = time.perf_counter()
            done = eng.run()[n_done:]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
        finally:
            attention.prefill_path = transformer.prefill_path = real_path
        tokens[route] = [req.out_tokens for req in sorted(done, key=lambda q: q.uid)]
        by_path: dict = {}
        for sp in tracer.spans[n_spans:]:
            if sp.name == "model.attn" and "path" in sp.attrs:
                by_path.setdefault(sp.attrs["path"], []).append((sp.t1 - sp.t0) * 1e3)
        row[route] = {"wall_s": wall, "launches": launches,
                      "attn_ms_by_path": {k: {"count": len(v), "mean_ms": float(np.mean(v))}
                                          for k, v in by_path.items()}}
        want = cfg.n_layers * len(prompts) if route == "kernel" else 0
        check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} requests completed")
        check(launches["prefill_attn"] == want,
              f"prefill_attn launches {launches['prefill_attn']} != {want} ({route})")
        check(set(by_path) == {route}, f"model.attn paths {sorted(by_path)} on the {route} route")
    row["launches"] = row["kernel"]["launches"]
    row["tokens_equal"] = tokens["kernel"] == tokens["plain"]
    emit(row)
    results["prefill serve"] = row
    check(row["tokens_equal"], "the prefill kernel's serve gave other tokens than the plain path's")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _wide_direct(torch, w, x, rec=None):
    """The wide engine's bare C entry on the wrapper's plan, with its output
    and x's pieces allocated once: a zero-argument launch (what the wrapper
    adds is its host time).  coded_matvec without rec, the decode with it."""
    from repro_torch.kernels import coded_decode, coded_matvec

    rows, m = w.shape
    b = x.shape[1]
    if rec is None:
        half = w.dtype == torch.float16
        plan = coded_matvec._wide_plan(w.device, rows, m, b, half)
        out = torch.empty(rows, b, device=w.device)
        fn = coded_matvec._wide_entry()
    else:
        n_data, nb = rec.shape
        half = False
        plan = coded_decode._wide_plan(w.device, rows, m, b, nb, n_data)
        out = torch.empty(n_data * (rows // nb), b, device=w.device)
        fn = coded_decode._wide_entry()
    xp = torch.empty(plan.xp_elements, dtype=torch.float16 if half else torch.bfloat16,
                     device=w.device)
    if rec is None:
        args = (w.data_ptr(), x.data_ptr(), xp.data_ptr(), out.data_ptr(), rows, m, b, int(half))
    else:
        args = (w.data_ptr(), x.data_ptr(), xp.data_ptr(), rec.data_ptr(), out.data_ptr(),
                rows // nb, m, b, nb, n_data)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, plan.grid, plan.cols, plan.stages, plan.smem_bytes, stream)
        check(err == 0 and out.numel() and xp.numel(), f"wide entry: cudaError {err}")

    return launch


def _wide_bounds(row: dict, n_bytes: float, rows: int, m: int, b: int, half: bool) -> None:
    """A wide row's three bounds: its bytes at 3.35 TB/s, its products on the
    tensor cores at 989 TFLOP/s (six bf16 products an fp32 one; one for
    fp16) and in fp32 outside them at 67 TFLOP/s; the first two bound it."""
    flops = 2.0 * rows * m * b
    row["byte_bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
    row["split_bound_ms"] = (1 if half else SPLIT_PRODUCTS) * flops / TC_BF16_FLOPS * 1e3
    row["fp32_simt_bound_ms"] = flops / FP32_FLOPS * 1e3
    row["bound_ms"], row["bound_by"] = max(
        (row["byte_bound_ms"], "bytes"), (row["split_bound_ms"], "operations"))


def _wide_counted(torch, wrapper, call) -> tuple:
    """call()'s output, and its launches and wide-engine launches."""
    before = (wrapper.launches, wrapper.wide_launches)
    out = call()
    return out, wrapper.launches - before[0], wrapper.wide_launches - before[1]


def kernel_coded_decode(torch, gen, results: dict) -> None:
    """coded_matvec_decode against ref_coded_matvec_decode: the glm4-9b head
    (14 + 2 blocks of 10826 rows x 4096), the mamba2-130m (tied, [50280,
    768]), zamba2-1.2b ([32000, 2048]), llama-3.2-vision-11b ([128256,
    4096]) and dbrx-132b ([100352, 6144]; x staged in panels at B = 4)
    heads (br = ceil(vocab / n_data)) at B = 1 (prefill) and 4 (decode) on
    the thin-row engine, timed in turns with torch.matmul(W_c, x), and
    through the wrapper against the bare C entry (head_host_cost); the wide
    engine (B >= WIDE_MIN_B, one launch a call, counted) at the mamba2-130m
    head at B = 17, 33 and 128 (the dry run's decode cell), the glm4-9b head
    at B = 8 (the dry run's cut cell), 64 and 128, and the dbrx-132b head at
    64, timed likewise (its error against a float64 product beside the fp32
    plain version's and torch.matmul's, its three bounds); and ragged shapes
    on both engines: odd br, M % 4 != 0 (scalar loads; the wide engine's own
    loads), tiles below the SM count, 1, 17 and 32 blocks, B = 300 (two
    column tiles).  Each is launched twice and the two results must be
    bit-equal."""
    from repro_torch.core.decoding import get_decoder_cache
    from repro_torch.kernels import ops, ref, thin_rows
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    dev = torch.device("cuda")
    rtol = 1e-4  # |kernel - plain| <= rtol * max(1, max|plain|): fp32, other sum order
    head_shapes = [("glm4-9b prefill", 14, 2, 10826, 4096, 1),
                   ("glm4-9b decode", 14, 2, 10826, 4096, 4),
                   ("glm4-9b decode after raise", 13, 3, 11658, 4096, 4),
                   ("mamba2-130m prefill", 14, 2, 3592, 768, 1),
                   ("mamba2-130m decode", 14, 2, 3592, 768, 4),
                   ("mamba2-130m decode after raise", 13, 3, 3868, 768, 4),
                   ("zamba2-1.2b prefill", 14, 2, 2286, 2048, 1),
                   ("zamba2-1.2b decode", 14, 2, 2286, 2048, 4),
                   ("zamba2-1.2b decode after raise", 13, 3, 2462, 2048, 4),
                   ("llama-3.2-vision-11b prefill", 14, 2, 9162, 4096, 1),
                   ("llama-3.2-vision-11b decode", 14, 2, 9162, 4096, 4),
                   ("llama-3.2-vision-11b decode after raise", 13, 3, 9866, 4096, 4),
                   # x [6144, 4] fp32 is 96 KB, over thin_rows.cuh's 64 KB
                   # resident cap: the decode at B = 4 stages x in panels
                   ("dbrx-132b prefill", 14, 2, 7168, 6144, 1),
                   ("dbrx-132b decode", 14, 2, 7168, 6144, 4),
                   ("dbrx-132b decode after raise", 13, 3, 7720, 6144, 4),
                   # the wide engine: the dryrun phase's glm4-9b decode cell
                   # (batch cut to 8) and mamba2-130m decode cell (B = 128),
                   # the 64-slot glm4-9b serve (B = 64)
                   ("glm4-9b decode B=8", 14, 2, 10826, 4096, 8),
                   ("mamba2-130m decode B=17", 14, 2, 3592, 768, 17),
                   ("mamba2-130m decode B=33", 14, 2, 3592, 768, 33),
                   ("mamba2-130m decode B=128", 14, 2, 3592, 768, 128),
                   ("glm4-9b decode B=64", 14, 2, 10826, 4096, 64),
                   ("glm4-9b decode B=128", 14, 2, 10826, 4096, 128),
                   ("dbrx-132b decode B=64", 14, 2, 7168, 6144, 64),
                   ("ragged", 13, 3, 1001, 4097, 3),
                   ("ragged", 6, 2, 77, 516, 16),
                   ("ragged M 4100", 6, 2, 300, 4100, 16),
                   # a dense R (no cache beyond 20 blocks): one block, tiles
                   # below the SMs; 17 blocks, one row each a tile; 32 blocks
                   ("ragged tiles below the SMs", 1, 0, 200, 260, 2),
                   ("ragged one row a tile", 17, 0, 133, 132, 5),
                   ("ragged 32 blocks", 30, 2, 70, 1028, 1),
                   # the wide engine's edges: M % 4 != 0 (its producer's own
                   # loads), 17 and 32 blocks, two column tiles
                   ("ragged wide M % 4", 13, 3, 1001, 4097, 20),
                   ("ragged wide one row a tile", 17, 0, 133, 132, 40),
                   ("ragged wide 32 blocks", 30, 2, 70, 1028, 33),
                   ("ragged wide B=300", 14, 2, 300, 4096, 300)]
    timed = ("glm4-9b prefill", "glm4-9b decode", "mamba2-130m prefill", "mamba2-130m decode",
             "zamba2-1.2b prefill", "zamba2-1.2b decode", "llama-3.2-vision-11b prefill",
             "llama-3.2-vision-11b decode", "dbrx-132b prefill", "dbrx-132b decode",
             "glm4-9b decode B=8", "mamba2-130m decode B=17", "mamba2-130m decode B=33",
             "mamba2-130m decode B=128", "glm4-9b decode B=64", "glm4-9b decode B=128",
             "dbrx-132b decode B=64")
    for label, n_data, n_parity, br, m, b in head_shapes:
        nb = n_data + n_parity
        wide = b >= WIDE_MIN_B
        w = torch.randn(nb * br, m, device=dev, generator=gen)
        x = torch.randn(m, b, device=dev, generator=gen)
        if nb <= 20 and n_parity:
            cache = get_decoder_cache(n_data, n_parity)
            recs = [((), cache.recovery(torch.ones(nb, device=dev)))]
            mask = torch.ones(nb, device=dev)
            mask[[1, nb - 1]] = 0.0
            recs.append(((1, nb - 1), cache.recovery(mask)))
        else:  # a dense R: every block adds into every decoded row
            recs = [((), torch.randn(n_data, nb, device=dev, generator=gen))]
        for erased, rec in recs:
            got, launches, wide_launches = _wide_counted(
                torch, coded_matvec_decode_cuda,
                lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"))
            want = ref.ref_coded_matvec_decode(w, x, rec)
            again = ops.coded_matvec_decode(w, x, rec, mode="cuda")
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, want)
            tol = rtol * max(1.0, scale)
            row = {"phase": "kernel", "kernel": "coded_matvec_decode", "shape": label,
                   "w": [nb * br, m], "b": b, "erased": list(erased),
                   "engine": "wide" if wide else "thin rows",
                   "launches_a_call": launches, "wide_launches_a_call": wide_launches,
                   "max_abs_err": err, "tol": tol, "bit_equal_relaunch": torch.equal(got, again)}
            if not wide:
                row["x_in_panels"] = b * -(-m // 4) * 4 * 4 > thin_rows.X_CAP_BYTES
            del got, again
            if wide and not erased and label in timed:
                # error against a float64 product, beside the fp32 plain
                # version's (torch.matmul, then R) and the block product's
                yc64 = w.double() @ x.double()
                want64 = torch.einsum("db,brc->drc", rec.double(),
                                      yc64.view(nb, br, b)).reshape(n_data * br, b)
                scale64 = float(want64.abs().max())
                got = ops.coded_matvec_decode(w, x, rec, mode="cuda")
                row["rel_err_f64"] = float((got.double() - want64).abs().max()) / scale64
                row["rel_err_f64_plain"] = float((want.double() - want64).abs().max()) / scale64
                row["rel_err_f64_matmul"] = (float((torch.matmul(w, x).double() - yc64).abs().max())
                                             / float(yc64.abs().max()))
                del yc64, want64, got
            del want
            if not erased and label in timed:
                row["ms"], row["library_ms"], row["turns_ms"] = time_turns(
                    torch, lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"),
                    lambda: torch.matmul(w, x), 10 if b > 16 and br > 5000 else 20)
                row["library_call"] = "torch.matmul(W_c, x), the block product alone (partial yardstick)"
                row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec_decode(w, x, rec), 20)
                n_bytes = 4 * (w.numel() + x.numel() + rec.numel() + n_data * br * b)
                if wide:
                    row["direct_ms"] = time_ms(torch, _wide_direct(torch, w, x, rec), 20)
                    row["host_ms_wrapper"] = host_ms(
                        torch, lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"))
                    _wide_bounds(row, n_bytes, nb * br, m, b, False)
                else:
                    head_host_cost(torch, row,
                                   lambda: ops.coded_matvec_decode(w, x, rec, mode="cuda"),
                                   "coded_decode", w, x, rec, 20)
                    n_ops = 2 * nb * br * m * b + 2 * n_data * nb * br * b
                    row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops)
                against_library(row)
                results.setdefault("coded_matvec_decode", {})[label] = row
            emit(row)
            check(err <= tol, f"coded_matvec_decode {label} erased={erased}: {err} > {tol}")
            check(row["bit_equal_relaunch"], f"coded_matvec_decode {label}: two launches differ")
            check(launches == 1 and wide_launches == int(wide),
                  f"coded_matvec_decode {label}: {launches} launches ({wide_launches} wide) a call")
            if "rel_err_f64" in row:
                check(row["rel_err_f64"] <= WIDE_ERR_VS_MATMUL * row["rel_err_f64_plain"],
                      f"coded_matvec_decode {label}: error {row['rel_err_f64']} against float64 "
                      f"over {WIDE_ERR_VS_MATMUL} x the fp32 plain version's "
                      f"{row['rel_err_f64_plain']}")
        del w, x
    torch.cuda.empty_cache()


def gaussian_row(torch, g, a, label: str, timed_iters: int = 0, engine: str | None = None,
                 f64: bool = False) -> dict:
    """gaussian_encode on (G, A) against ref_gaussian_encode, to 1e-4 x
    max(1, max|plain|) (fp32, another sum order), on the engine the wrapper
    picks (``engine`` forces one); with ``f64`` also against G·A in float64
    (in column pieces), where the tensor-core engine must be within
    WIDE_ERR_VS_MATMUL x fp32 torch.matmul's error; with ``timed_iters``,
    also timed in turns with torch.matmul(G, A), beside its plain version
    and bound (the tensor-core engine's: six bf16 products an fp32 one at
    989 TFLOP/s, or the bytes; the register engine's: fp32 at 67 TFLOP/s,
    or the bytes)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, gaussian_engine

    (q, r), m = g.shape, a.shape[1]
    eng = engine or gaussian_engine(q)
    call = lambda: gaussian_encode_cuda(g, a, engine=eng)  # noqa: E731
    before = (gaussian_encode_cuda.launches, gaussian_encode_cuda.wide_launches)
    got = call()
    launched = (gaussian_encode_cuda.launches - before[0],
                gaussian_encode_cuda.wide_launches - before[1])
    want = ref.ref_gaussian_encode(g, a)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    tol = 1e-4 * max(1.0, scale)
    row = {"phase": "kernel", "kernel": "gaussian_encode", "engine": eng, "shape": label,
           "g": [q, r], "a": [r, m], "max_abs_err": err, "tol": tol,
           "launches_a_call": launched[0], "wide_launches_a_call": launched[1]}
    if f64:  # column pieces of G·A in float64 on the card
        g64, num, num32, den = g.double(), 0.0, 0.0, 0.0
        step = max(1, (1 << 28) // (8 * max(q, r)))
        for c0 in range(0, m, step):
            w64 = g64 @ a[:, c0:c0 + step].double()
            num = max(num, float((got[:, c0:c0 + step].double() - w64).abs().max()))
            num32 = max(num32, float((want[:, c0:c0 + step].double() - w64).abs().max()))
            den = max(den, float(w64.abs().max()))
            del w64
        row["rel_err_f64"], row["rel_err_f64_plain"] = num / den, num32 / den
    del got, want
    if timed_iters:
        row["ms"], row["library_ms"], row["turns_ms"] = time_turns(
            torch, call, lambda: torch.matmul(g, a), timed_iters)
        row["library_call"] = "torch.matmul(G, A)"
        row["plain_ms"] = time_ms(torch, lambda: ref.ref_gaussian_encode(g, a), timed_iters)
        n_bytes = 4 * (q * r + r * m + q * m)
        if eng == "wide":
            _wide_bounds(row, n_bytes, q, r, m, False)
        else:
            row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * q * r * m)
        against_library(row)
    emit(row)
    check(err <= tol, f"gaussian_encode {label}: {err} > {tol}")
    check(launched == (1, int(eng == "wide")),
          f"gaussian_encode {label}: {launched} launches (all, wide) for one {eng} call")
    if f64 and eng == "wide":
        check(row["rel_err_f64"] <= WIDE_ERR_VS_MATMUL * row["rel_err_f64_plain"],
              f"gaussian_encode {label}: error {row['rel_err_f64']} against float64 over "
              f"{WIDE_ERR_VS_MATMUL} x fp32 torch.matmul's {row['rel_err_f64_plain']}")
    return row


def kernel_gaussian(torch, gen, results: dict) -> None:
    """gaussian_encode at the (13, 3) parity re-encodes of the glm4-9b,
    mamba2-130m, zamba2-1.2b, llama-3.2-vision-11b and dbrx-132b heads, G [16, 13] x A [13, br * d_model],
    timed (the register engine); then ragged shapes on both engines: every
    q-tile edge, an r across G's shared-memory panel, M = 1, M % 4 != 0, a
    misaligned view of A (scalar loads; the tensor-core engine's producer
    loads A itself), r not a multiple of 16, q over two column tiles, and
    the Gaussian task's q = 564 at a ragged M, held to float64 too."""
    dev = torch.device("cuda")
    enc_shapes = [("glm4-9b raise", 16, 13, 11658 * 4096),
                  ("mamba2-130m raise", 16, 13, 3868 * 768),
                  ("zamba2-1.2b raise", 16, 13, 2462 * 2048),
                  ("llama-3.2-vision-11b raise", 16, 13, 9866 * 4096),
                  ("dbrx-132b raise", 16, 13, 7720 * 6144),
                  ("ragged", 33, 40, 257), ("ragged", 5, 3, 1001), ("ragged", 16, 14, 1),
                  *(("ragged q-tile edge", q, 13, 100_003) for q in (1, 8, 9, 17, 26, 32, 33, 70)),
                  ("ragged r across panels", 32, 1500, 20_000),
                  ("misaligned view", 26, 500, 20_000), ("misaligned view", 40, 500, 20_000),
                  ("ragged r % 16 != 0", 100, 77, 1001), ("ragged M % 4 != 0", 300, 1000, 4097),
                  ("ragged two column tiles", 257, 100, 3000),
                  ("ragged Gaussian task rows", 564, 500, 100_003)]
    for label, q, r, m in enc_shapes:
        g = torch.randn(q, r, device=dev, generator=gen)
        if label.startswith("misaligned"):
            a = torch.randn(1 + r * m, device=dev, generator=gen)[1:].view(r, m)
            check(a.data_ptr() % 16 != 0, "the misaligned view is aligned")
        else:
            a = torch.randn(r, m, device=dev, generator=gen)
        timed = label.endswith("raise")
        row = gaussian_row(torch, g, a, label, 10 if timed else 0, f64=not timed and r >= 500)
        if timed:
            results.setdefault("gaussian_encode", {})[label] = row
        else:  # the engine the wrapper did not pick, and float64 where K is the task's
            other = "register" if row["engine"] == "wide" else "wide"
            gaussian_row(torch, g, a, f"{label} ({other})", engine=other, f64=r >= 500)
        del g, a
    torch.cuda.empty_cache()


def kernel_coded_matvec(torch, gen, results: dict) -> None:
    """coded_matvec against ref_coded_matvec: the mesh head's code block of
    glm4-9b ([10826, 4096], B = 1 and 4; [11658, 4096] after the (13, 3)
    raise), the whole W_c [173216, 4096] (``kernels.ops.coded_matvec``'s
    single-device form) and the block in fp16 on the thin-row engine, timed
    in turns with torch.matmul, and through the wrapper against the bare C
    entry (head_host_cost); the block on the wide engine (B >= WIDE_MIN_B,
    one launch a call, counted) at B = 17, 33, 64 and 128 and in fp16 at 64,
    timed likewise (its error against a float64 product beside fp32
    torch.matmul's, its three bounds); ragged shapes on both engines, rows
    below and just above the SM count, fp16, M % 4 != 0 and a misaligned
    block view (the wide engine's own loads), B = 300 (two column tiles).
    Each is launched twice and the two results must be bit-equal."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    dev = torch.device("cuda")
    shapes = [  # label, rows, M, B, dtype, timed
        ("glm4-9b block prefill", 10826, 4096, 1, torch.float32, True),
        ("glm4-9b block decode", 10826, 4096, 4, torch.float32, True),
        ("glm4-9b block after raise", 11658, 4096, 4, torch.float32, True),
        ("glm4-9b whole W_c", 173216, 4096, 4, torch.float32, True),
        ("glm4-9b block decode fp16", 10826, 4096, 4, torch.float16, True),
        # the wide engine: one launch and one read of A a call
        ("glm4-9b block B=17", 10826, 4096, 17, torch.float32, True),
        ("glm4-9b block B=33", 10826, 4096, 33, torch.float32, True),
        ("glm4-9b block B=64", 10826, 4096, 64, torch.float32, True),
        ("glm4-9b block B=128", 10826, 4096, 128, torch.float32, True),
        ("glm4-9b block B=64 fp16", 10826, 4096, 64, torch.float16, True),
        ("ragged", 513, 129, 3, torch.float32, False),
        ("ragged", 100, 70, 1, torch.float32, False),
        ("ragged", 1, 4096, 1, torch.float32, False),
        ("ragged fp16", 513, 129, 3, torch.float16, False),
        ("ragged rows below the SMs", 131, 4096, 4, torch.float32, False),
        ("ragged rows just above the SMs", 133, 4100, 2, torch.float32, False),
        ("ragged M 4100", 1000, 4100, 16, torch.float32, False),
        ("ragged M 4104 fp16", 1000, 4104, 16, torch.float16, False),
        ("misaligned block view", 1001, 4097, 4, torch.float32, False),
        ("ragged wide M % 4", 513, 4097, 20, torch.float32, False),
        ("ragged wide M % 8 fp16", 513, 1030, 24, torch.float16, False),
        ("misaligned block view wide", 1001, 4097, 40, torch.float32, False),
        ("ragged wide B=300", 1001, 4096, 300, torch.float32, False),
    ]
    for label, rows, m, b, dtype, timed in shapes:
        wide = b >= WIDE_MIN_B
        if label.startswith("misaligned"):
            # block 3 of a 16-block coded weight with M odd: starts 4 bytes
            # past a 16-byte boundary, so the kernel takes its scalar loads
            # (the wide engine: its producer's own loads, not the TMA)
            whole = torch.randn(16 * rows, m, device=dev, generator=gen)
            a = whole.chunk(16)[3]
            check(a.data_ptr() % 16 != 0, "the misaligned view is aligned")
        else:
            a = torch.randn(rows, m, device=dev, generator=gen).to(dtype)
        x = torch.randn(m, b, device=dev, generator=gen).to(dtype)
        if b == 1:
            x = x[:, 0]
        got, launches, wide_launches = _wide_counted(
            torch, coded_matvec_cuda, lambda: ops.coded_matvec(a, x, mode="cuda"))
        want = ref.ref_coded_matvec(a, x)
        again = ops.coded_matvec(a, x, mode="cuda")
        torch.cuda.synchronize()
        err, scale = max_err(torch, got, want)
        # fp32: 1e-4 * max(1, max|plain|), another sum order; fp16 inputs
        # (fp32 sums in both): the reference's fp16 bound, 2e-3
        tol = (1e-4 if dtype == torch.float32 else 2e-3) * max(1.0, scale)
        row = {"phase": "kernel", "kernel": "coded_matvec", "shape": label,
               "a": [rows, m], "b": b, "dtype": str(dtype).removeprefix("torch."),
               "engine": "wide" if wide else "thin rows",
               "launches_a_call": launches, "wide_launches_a_call": wide_launches,
               "max_abs_err": err, "tol": tol, "bit_equal_relaunch": torch.equal(got, again)}
        if wide and timed:
            # error against a float64 product, beside fp32 torch.matmul's
            want64 = a.double() @ x.double()
            scale64 = float(want64.abs().max())
            row["rel_err_f64"] = float((got.double() - want64).abs().max()) / scale64
            row["rel_err_f64_matmul"] = (float((torch.matmul(a.float(), x.float()).double()
                                                - want64).abs().max()) / scale64)
            del want64
        del got, want, again
        if timed:
            iters = 10 if rows > 100_000 else 50
            row["ms"], row["library_ms"], row["turns_ms"] = time_turns(
                torch, lambda: ops.coded_matvec(a, x, mode="cuda"), lambda: torch.matmul(a, x),
                iters)
            row["library_call"] = f"torch.matmul(A, x) in {row['dtype']}"
            row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec(a, x), iters)
            n_bytes = a.element_size() * (a.numel() + x.numel()) + 4 * rows * b
            if wide:
                row["direct_ms"] = time_ms(torch, _wide_direct(torch, a, x), iters)
                row["host_ms_wrapper"] = host_ms(torch, lambda: ops.coded_matvec(a, x, mode="cuda"))
                _wide_bounds(row, n_bytes, rows, m, b, dtype == torch.float16)
            else:
                head_host_cost(torch, row, lambda: ops.coded_matvec(a, x, mode="cuda"),
                               "coded_matvec", a, x, None, iters)
                row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * rows * m * b)
            against_library(row)
            results.setdefault("coded_matvec", {})[label] = row
        emit(row)
        check(err <= tol, f"coded_matvec {label}: {err} > {tol}")
        check(row["bit_equal_relaunch"], f"coded_matvec {label}: two launches differ")
        check(launches == 1 and wide_launches == int(wide),
              f"coded_matvec {label}: {launches} launches ({wide_launches} wide) a call")
        if "rel_err_f64" in row:
            check(row["rel_err_f64"] <= WIDE_ERR_VS_MATMUL * row["rel_err_f64_matmul"],
                  f"coded_matvec {label}: error {row['rel_err_f64']} against float64 over "
                  f"{WIDE_ERR_VS_MATMUL} x fp32 torch.matmul's {row['rel_err_f64_matmul']}")
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


def _ssd_simt(torch):
    """The SIMT kernels' C entries (ssd_chunk_simt, ssd_combine_simt): the
    route bf16 cells took before the tensor cores, kept for timing beside
    them.  Returns (chunk, combine), each called on tensors like the
    wrappers."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.load("ssd_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    chunk, combine = lib.ssd_chunk_simt, lib.ssd_combine_simt
    chunk.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, i, vp]
    combine.argtypes = [vp] * 4 + [ctypes.c_longlong, i, i, i, i, vp]
    chunk.restype = combine.restype = i

    def run_chunk(x, da, b, c, out):
        g, q, p = x.shape
        err = chunk(x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
                    *(t.data_ptr() for t in out), g, q, p, b.shape[2],
                    int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"ssd_chunk_simt: cudaError {err}")

    def run_combine(c, cum, s_in, out):
        g, q, n = c.shape
        err = combine(c.data_ptr(), cum.data_ptr(), s_in.data_ptr(), out.data_ptr(), g, q,
                      s_in.shape[1], n, int(c.dtype == torch.bfloat16),
                      torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"ssd_combine_simt: cudaError {err}")

    return run_chunk, run_combine


def _ssd_bounds(g: int, q: int, p: int, n: int, elt: int) -> tuple[tuple, tuple]:
    """(bytes, operations) of ssd_chunk and of ssd_combine over G cells:
    each input read once, each output written once; the bf16 route's
    tensor operations with its three passes (one for C·Bᵀ, whose operands
    are both bf16), over the causal half (l >= s) that the function needs."""
    causal = q * (q + 1) // 2
    chunk_bytes = elt * g * q * (p + 2 * n) + 4 * (g * q + g * q * p + g * p * n + g + g * q)
    chunk_ops = g * (2 * causal * n + 3 * 2 * causal * p + 3 * 2 * q * p * n)
    combine_bytes = elt * g * q * n + 4 * (g * q + g * p * n + g * q * p)
    combine_ops = g * (3 * 2 * q * n * p + q * p)
    return (chunk_bytes, chunk_ops), (combine_bytes, combine_ops)


def _ssd_timed(torch, row_c: dict, row_m: dict, x, da, b, c, cum, s_in) -> None:
    """Times of the bf16 route at one prompt's cells: ssd_chunk in turns with
    the SIMT kernel it replaced, ssd_combine in turns with it and with its
    einsum; the plain versions alone; bounds by bytes at 3.35 TB/s and by
    the tensor operations (three passes) at 989 TFLOP/s."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    g, q, p = x.shape
    n = b.shape[2]
    simt_chunk, simt_combine = _ssd_simt(torch)
    out = [torch.empty_like(t) for t in ssd_chunk_cuda(x, da, b, c)]
    y_off = torch.empty(g, q, p, device=x.device)
    row_c["route"] = row_m["route"] = "tensor cores (mma.sync bf16, fp32 operand in 3 bf16 pieces)"
    row_c["ms"], row_c["simt_ms"], row_c["simt_turns_ms"] = time_turns(
        torch, lambda: ssd_chunk_cuda(x, da, b, c), lambda: simt_chunk(x, da, b, c, out), 20)
    row_c["ratio_to_simt"] = row_c["ms"] / row_c["simt_ms"]
    row_c["plain_ms"] = time_ms(torch, lambda: ref.ref_ssd_chunk(x, da, b, c), 3)
    row_c["library_ms"] = None  # no one PyTorch call computes it
    row_m["ms"], row_m["library_ms"], row_m["turns_ms"] = time_turns(
        torch, lambda: ssd_combine_cuda(c, cum, s_in),
        lambda: torch.einsum("gln,gpn,gl->glp", c.float(), s_in, cum.exp()), 20)
    row_m["library_call"] = "torch.einsum('gln,gpn,gl->glp', C.float(), S_in, exp(cum))"
    row_m["ms_simt_turns"], row_m["simt_ms"], _ = time_turns(
        torch, lambda: ssd_combine_cuda(c, cum, s_in),
        lambda: simt_combine(c, cum, s_in, y_off), 20)
    row_m["ratio_to_simt"] = row_m["ms_simt_turns"] / row_m["simt_ms"]
    row_m["plain_ms"] = time_ms(torch, lambda: ref.ref_ssd_combine(c, cum, s_in), 5)
    (cb, co), (mb, mo) = _ssd_bounds(g, q, p, n, x.element_size())
    row_c["bound_ms"], row_c["bound_by"] = bound(cb, co, TC_BF16_FLOPS)
    row_m["bound_ms"], row_m["bound_by"] = bound(mb, mo, TC_BF16_FLOPS)
    row_c["bound_share"] = row_c["bound_ms"] / row_c["ms"]
    against_library(row_m)
    print(f"ssd {row_c['shape']}: chunk {row_c['ms']:.4f} ms ({row_c['ratio_to_simt']:.3f}x SIMT "
          f"{row_c['simt_ms']:.4f}), combine {row_m['ms']:.4f} ms ({row_m['ratio']:.3f}x einsum "
          f"{row_m['library_ms']:.4f}; {row_m['ratio_to_simt']:.3f}x SIMT {row_m['simt_ms']:.4f})",
          flush=True)


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
                _ssd_timed(torch, row_c, row_m, x, da, b, c, want[3], s_in)
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


# the dryrun phase's SSD cells (bf16): zamba2-1.2b's 32,768-token prefill at
# batch 1 (G 64 heads x 128 chunks), and mamba2-130m's train step at 8 x 4,096
# tokens (G 32 heads x 8 sequences x 16 chunks: cells of the same shape as
# one 32,768-token sequence's)
SSD_DRYRUN = (("zamba2-1.2b 32768 bfloat16", "zamba2-1.2b", 32768),
              ("mamba2-130m train 8x4096 bfloat16", "mamba2-130m", 8 * 4096))


def kernel_ssd_dryrun(torch, results: dict) -> None:
    """ssd_chunk and ssd_combine against their plain versions at the dryrun
    phase's cells (the reference tests' decay), timed as the 4096-token
    cells are (``_ssd_timed``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    for label, arch, s in SSD_DRYRUN:
        heads, p, n = SSD_WIDTHS[arch]
        x, da, b, c = _ssd_cells(torch, gen, heads, p, n, s, torch.bfloat16)
        g, q = da.shape
        got = ssd_chunk_cuda(x, da, b, c)
        want = ref.ref_ssd_chunk(x, da, b, c)
        s_in = 0.1 * torch.randn(g, p, n, device=dev, generator=gen)
        y_off = ssd_combine_cuda(c, want[3], s_in)
        y_off_want = ref.ref_ssd_combine(c, want[3], s_in)
        torch.cuda.synchronize()
        checks = dict(zip(("y_diag", "states", "decay", "cum"),
                          (_ssd_check(torch, gv, wv) for gv, wv in zip(got, want))))
        comb = _ssd_check(torch, y_off, y_off_want)
        del got, y_off, y_off_want
        row_c = {"phase": "kernel", "kernel": "ssd_chunk", "shape": label, "g": g, "q": q,
                 "p": p, "n": n, "dtype": "bfloat16", "da_draw": "reference",
                 "errors": {k: v[0] for k, v in checks.items()},
                 "tols": {k: v[1] for k, v in checks.items()},
                 "max_abs_err": checks["y_diag"][0], "tol": checks["y_diag"][1]}
        row_m = {"phase": "kernel", "kernel": "ssd_combine", "shape": label, "g": g, "q": q,
                 "p": p, "n": n, "dtype": "bfloat16", "da_draw": "reference",
                 "max_abs_err": comb[0], "tol": comb[1]}
        for k, (err, tol, ok) in checks.items():
            check(ok, f"ssd_chunk {label} {k}: max err {err}, allowed {tol}")
        check(comb[2], f"ssd_combine {label}: max err {comb[0]}, allowed {comb[1]}")
        _ssd_timed(torch, row_c, row_m, x, da, b, c, want[3], s_in)
        results.setdefault("ssd_chunk", {})[label] = row_c
        results.setdefault("ssd_combine", {})[label] = row_m
        emit(row_c)
        emit(row_m)
        del x, da, b, c, want, s_in
        torch.cuda.empty_cache()


AUTO_BUDGET_S = 120.0   # the auto phase's share of the smoke's 1,200 s


def _auto_row(d) -> dict:
    """A dispatch Decision as printed: its source, impl, the model's
    prediction and the table's measured time (µs)."""
    return {"source": d.source, "impl": d.impl, "predicted_us": d.predicted_us,
            "table_us": d.measured_us}


def phase_auto_glm(torch, args, serve: dict, mesh, results: dict, smi: str) -> None:
    """Phase 10: ``kernel_mode='auto'`` on the glm4-9b path, through the
    committed dispatch table (``reports/bench/cuda/autotune.json``): the
    head, the mesh head, a scalar serve with its raise, a fused macro pair
    and the two task encodes, each bit-equal to its explicit mode.  Only
    the 'auto' calls' launches are the path's (``path``); the comparisons'
    are not."""
    from repro_torch.core.coded_ops import CodedLinear, block_mds_generator
    from repro_torch.kernels import autotune, cost, dispatch, ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding import shard_coded_head

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    path = dict.fromkeys(_launches(), 0)

    def counted(fn):
        """fn()'s result, its launches added to the path's (counts set to 0 just before)."""
        _reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for name, n in _launches().items():
            path[name] += n
        return out

    # 1. the committed table
    dispatch.set_table_path(None)
    table = dispatch.get_table()
    check(table is not None, f"no dispatch table at {dispatch.default_table_path()}")
    meta = table.doc["meta"]
    check("H100" in meta["card"], f"the committed table was measured on {meta['card']}")
    worst = 0.0
    for e in table.entries.values():
        kernels = ("fused", "svd") if e["op"] == "coded_linear" else ("cuda",)
        check(e["backend"] == "cuda" and e["impl"] in kernels and e["mode"] == "cuda",
              f"table winner {e['op']} {e['shape']} is not a kernel: {e['impl']} {e['mode']}")
        check(e["model_error"] <= cost.MODEL_ERROR_BOUND,
              f"table winner {e['op']} {e['shape']}: model error {e['model_error']}")
        worst = max(worst, e["model_error"])
    emit({"phase": "auto_table", "path": dispatch.default_table_path(),
          "entries": len(table.entries), "measured_on": meta["card"], "torch": meta["torch"],
          "cuda": meta["cuda"], "worst_model_error": worst, "bound": cost.MODEL_ERROR_BOUND})

    # 2. the glm4-9b head at full width
    cfg, params = serve["cfg"], serve["params"]
    wc = params["lm_head_coded"]
    br = wc.shape[0] // 16
    cl = CodedLinear(14, 2, 14 * br)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    heads = []
    for b in (1, 4):
        x = torch.randn(cfg.d_model, b, device=dev, generator=gen)
        for erased in ((), (4, 11)):
            mask = torch.ones(16, device=dev)
            mask[list(erased)] = 0.0
            d = dispatch.choose_coded_linear(cl.out_features, cfg.d_model, b, 14, 2,
                                             backend="cuda")
            got = counted(lambda: cl.apply(wc, x, mask, kernel_mode="auto"))
            explicit = cl.apply(wc, x, mask, kernel_mode=d.kernel_mode)
            default = cl.apply(wc, x, mask)
            plain = cl.apply(wc, x, mask, kernel_mode="off")
            torch.cuda.synchronize()
            scale = float(plain.abs().max())
            err = float((got - plain).abs().max())
            row = {"phase": "auto_head", "arch": cfg.name, "w_coded": list(wc.shape), "b": b,
                   "erased": list(erased), "decision": _auto_row(d),
                   "equal_explicit": bool(torch.equal(got, explicit)),
                   "equal_default": bool(torch.equal(got, default)),
                   "max_abs_err_vs_plain": err, "tol": 1e-3 * scale,
                   "ms": time_ms(torch, lambda: cl.apply(wc, x, mask, kernel_mode="auto"), 10)}
            heads.append(row)
            emit(row)
            check(d.mode == "cuda" and d.impl in ("fused", "svd"), f"auto head decision {d}")
            check(row["equal_explicit"], f"auto head B={b} {erased}: not the explicit mode's bits")
            check(row["equal_default"] or d.impl == "svd",
                  f"auto head B={b} {erased}: not the default's bits")
            check(err <= 1e-3 * scale, f"auto head B={b} {erased}: {err} > 1e-3 x {scale}")

    # 3. the mesh head: one coded_matvec a block, per its own decision
    placed = shard_coded_head(wc, mesh)
    x = torch.randn(cfg.d_model, 4, device=dev, generator=gen)
    for erased in ((), (5, 12)):
        mask = torch.ones(16, device=dev)
        mask[list(erased)] = 0.0
        got = counted(lambda: ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh,
                                                    kernel_mode="auto"))
        want = ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh)
        check(torch.equal(got, want), f"auto mesh head {erased}: not the default's bits")
    d_block = dispatch.choose_matvec(br, cfg.d_model, 4, backend="cuda")
    emit({"phase": "auto_mesh_head", "block": list(placed[0].shape), "b": 4,
          "decision": _auto_row(d_block), "equal_default": True})

    # 4. a scalar serve under 'auto', the (14, 2) -> (13, 3) raise encoded through it
    eng = serve["make_engine"](params, head_kernel_mode="auto", encode_mode="auto")
    for i, prompt in enumerate(serve["prompts"]):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=serve["max_new"]))
    before = dict(path)
    done = counted(eng.run)
    served = {k: path[k] - before[k] for k in path}
    tokens = {r.uid: r.out_tokens for r in done}
    n_req = len(serve["prompts"])
    check(tokens == serve["tokens"], "auto serve tokens differ from the serve phase's ('cuda')")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"auto serve parity events {eng.parity_events}")
    check(served["coded_matvec_decode"] == n_req + eng._steps and served["gaussian_encode"] == 1,
          f"auto serve launches {served}: want {n_req} prefills + {eng._steps} steps, one raise")
    emit({"phase": "auto_serve", "arch": cfg.name, "requests": n_req,
          "decode_steps": eng._steps, "tokens_equal_cuda_serve": True,
          "parity_events": eng.parity_events, "launches": served})
    del eng

    # 5. a fused macro pair under 'auto': one wave each, equal tokens
    model = build_model(cfg)
    fixed = np.ones(16)
    fixed[[3, 12]] = 0.0
    prompts = [serve["rng"].integers(0, cfg.vocab, 16) for _ in range(4)]
    waves = {}
    for k in (1, 16):
        eng = ServeEngine(model, params, n_slots=4, s_max=64, mask_fn=lambda: fixed,
                          head_kernel_mode="auto", macro_steps=k, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
        before = dict(path)
        done = counted(eng.run)
        launches = {n: path[n] - before[n] for n in path}
        warmups = len(eng.graph_log)
        check(launches["coded_matvec_decode"] == len(prompts) + eng._steps + warmups,
              f"auto macro K={k}: launches {launches} != {len(prompts)} prefills + "
              f"{eng._steps} steps + {warmups} warm-ups")
        waves[k] = {"tokens": {r.uid: r.out_tokens for r in done}, "steps": eng._steps,
                    "macro_blocks": eng.macro_blocks, "captures": warmups, "launches": launches}
        del eng
    check(waves[16]["tokens"] == waves[1]["tokens"], "auto macro: fused tokens differ from scalar")
    check(waves[16]["macro_blocks"] > 0, "auto macro: no fused block ran")
    emit({"phase": "auto_macro", "arch": cfg.name, "requests": len(prompts), "max_new": 32,
          **{f"k{k}": {n: v for n, v in w.items() if n != "tokens"} for k, w in waves.items()},
          "tokens_equal": True,
          "block_decision": _auto_row(dispatch.choose_coded_linear(
              cl.out_features, cfg.d_model, 4, 14, 2, backend="cuda", macro_k=16))})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the encodes on A seeded on the card
    rbr = -(-cfg.vocab // 13)
    a = torch.randn(13, rbr * cfg.d_model, device=dev, generator=gen)
    g = block_mds_generator(16, 13, device=dev)
    got = counted(lambda: ops.gaussian_encode(g, a, "auto"))
    check(torch.equal(got, ops.gaussian_encode(g, a, "cuda")),
          "auto gaussian_encode at the glm4-9b raise: not the 'cuda' bits")
    enc = {"gaussian_encode": _auto_row(dispatch.choose_encode(
        "gaussian", 16, 13, a.shape[1], backend="cuda"))}
    del a, got
    r, plan = autotune.lt_task_table(args.seed)
    a = torch.randn(r, PAPER_M, device=dev, generator=gen)
    idx = torch.as_tensor(plan.indices, device=dev)
    cof = torch.as_tensor(plan.coeffs, device=dev)
    got = counted(lambda: ops.lt_encode(a, idx, cof, "auto"))
    check(torch.equal(got, ops.lt_encode(a, idx, cof, "cuda")),
          "auto lt_encode at the LT task's reserve: not the 'cuda' bits")
    enc["lt_encode"] = _auto_row(dispatch.choose_encode(
        "lt", plan.q, r, PAPER_M, d_max=idx.shape[1], backend="cuda"))
    emit({"phase": "auto_encode", "raise": [16, 13, rbr * cfg.d_model],
          "lt": [plan.q, r, PAPER_M], "decisions": enc, "equal_cuda": True})
    del a, got, idx, cof
    torch.cuda.empty_cache()

    for name in ("coded_matvec_decode", "coded_matvec", "gaussian_encode", "lt_encode"):
        check(path[name] > 0, f"auto phase: {name} never launched on the 'auto' path")
    seconds = time.perf_counter() - t_phase
    row = {"phase": "auto_glm", "launches": path, "seconds": seconds, "budget_s": AUTO_BUDGET_S,
           "within_budget": seconds <= AUTO_BUDGET_S, "card": smi}
    emit(row)
    results["auto glm4-9b"] = {"launches": path, "heads": heads, "seconds": seconds}


# each kernel's second engine, counted apart (``<engine>_launches``): the
# tensor-core engine of the head kernels and of gaussian_encode, lt_encode's
# shared-memory slab engine, prefill_attn's prologue
ENGINES = {"coded_matvec": "wide", "coded_matvec_decode": "wide", "gaussian_encode": "wide",
           "lt_encode": "slab", "prefill_attn": "prologue"}


def _reset_launches() -> None:
    from repro_torch.kernels import kernel_wrappers

    for name, fn in kernel_wrappers().items():
        fn.launches = 0
        if name in ENGINES:
            setattr(fn, f"{ENGINES[name]}_launches", 0)


def _launches() -> dict:
    """Each kernel's launches, and those of its second engine
    (``<name>_wide``, ``lt_encode_slab``: a part of ``<name>``'s)."""
    from repro_torch.kernels import kernel_wrappers

    wrappers = kernel_wrappers()
    return {**{name: fn.launches for name, fn in wrappers.items()},
            **{f"{name}_{eng}": getattr(wrappers[name], f"{eng}_launches")
               for name, eng in ENGINES.items()}}


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
    it; with a device encode the row holds what was encoded (all of Â: its
    static and reserve rows) and the seconds of the copy in, the encode and
    the copy out; returns (row, result, emulator)."""
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
        row["encode"] = {k: enc[k] for k in ("kind", "rows", "static_rows", "reserve_rows",
                                             "nonzeros", "h2d_s", "encode_s", "d2h_s")}
    return row, res, em


def _same_trajectory(dev_res, host_res) -> bool:
    return (dev_res.arrivals == host_res.arrivals
            and dev_res.reallocations == host_res.reallocations
            and dev_res.rows_assigned == host_res.rows_assigned
            and dev_res.t_complete == host_res.t_complete)


def _trajectory_pair(torch, r: int, m: int, workers, code: str, seed: int,
                     x_seed: int) -> dict:
    """The task run twice at a narrower width m, with the device encode and
    with the host encode, on one seed: the trajectory (arrivals,
    reallocations, rows assigned, t_complete) must not depend on where Â is
    encoded, and the host encode's y is held to A·x as the device's."""
    t0 = time.perf_counter()
    a, x, y_ref = _task_inputs(torch, r, m, x_seed)
    inputs_s = time.perf_counter() - t0
    dev_row, dev_res, _ = _run_task(torch, a, x, y_ref, workers, code, "device", seed)
    host_row, host_res, _ = _run_task(torch, a, x, y_ref, workers, code, None, seed)
    pair = {"m": m, "inputs_s": inputs_s, "device_encode": dev_row, "host_encode": host_row,
            "same_trajectory": _same_trajectory(dev_res, host_res),
            "y_max_abs_diff_device_vs_host": float(np.abs(dev_res.y - host_res.y).max())}
    check(dev_res.ok and host_res.ok, f"{code} task pair at m = {m} did not decode")
    check(host_row["max_rel_err"] <= 2e-3,
          f"{code} task (host encode) rel err {host_row['max_rel_err']}")
    check(pair["same_trajectory"], f"{code}: device and host encode runs differ in arrivals, "
                                   f"reallocations or rows assigned")
    del a, x, y_ref, dev_res, host_res
    gc.collect()
    return pair


def phase_task_lt(torch, args, results: dict, smi: str) -> None:
    """The paper's task form at scenario 1 through the port's run_task, all of
    Â (static rows and reserve) LT-encoded on the card in one launch by
    TaskSpec's default encode_mode; the host encode's run beside a device run
    at a narrower m (the trajectory check); then lt_encode at the full run's
    shapes."""
    from repro_torch.cluster import ec2_scenario

    r, workers = ec2_scenario(1)
    m, cut = PAPER_M, None
    # host bytes per A byte, the process's peak on this path: A, the coded
    # rows (capacity ~1.75 r) held once by the master and once spread over
    # the workers, and room for the reference copy of y and the pair's inputs
    need_per_col = 5.0 * r * 4 / 1e9
    avail = _mem_available_gb()
    if need_per_col * m > 0.9 * avail:
        cut = {"m": int(0.9 * avail / need_per_col), "of_m": m,
               "reason": f"host memory: {avail:.1f} GB available, "
                         f"{need_per_col * m:.1f} GB reckoned at m = {m}"}
        emit({"phase": "cut", "task": "lt", **cut})
        m = cut["m"]
    pair_cut = {"same_trajectory_m": LT_PAIR_M, "of_m": m, "reason": PAIR_REASON}
    emit({"phase": "cut", "task": "lt", **pair_cut})
    t0 = time.perf_counter()
    a, x, y_ref = _task_inputs(torch, r, m, args.seed)
    inputs_s = time.perf_counter() - t0
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "lt", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran")
    plan, static_rows = enc["plan"], enc["static_rows"]
    del em
    check(dev_res.ok, "LT task (device encode) did not decode")
    check(dev_row["max_rel_err"] <= 2e-3, f"LT task rel err {dev_row['max_rel_err']} > 2e-3")
    check(enc["rows"] == dev_row["rows_assigned"],
          f"the encode made {enc['rows']} rows of {dev_row['rows_assigned']} assigned")
    check(enc["reserve_rows"] > 0, "top-ups drew no reserve rows")
    slab = int(_slab_fits(plan.indices, plan.coeffs, r, m))
    check(dev_row["launches"]["lt_encode"] == 1 and dev_row["launches"]["lt_encode_slab"] == slab,
          f"lt_encode launches {dev_row['launches']} ({slab} expected on the slab engine)")
    del dev_res
    gc.collect()
    t1 = time.perf_counter()
    pair = _trajectory_pair(torch, r, LT_PAIR_M, workers, "lt", args.seed, args.seed)
    row = {"phase": "task", "code": "lt", "scenario": 1, "r": r, "m": m,
           "cut": cut, "pair_cut": pair_cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE, "inputs_s": inputs_s,
           "static_rows": static_rows, "reserve_rows": enc["reserve_rows"],
           "device_encode": dev_row, "pair": pair,
           "same_trajectory": pair["same_trajectory"],
           "seconds": {"inputs": inputs_s, "device_run": dev_row["run_task_wall_s"],
                       "pair": time.perf_counter() - t1},
           "card": smi}
    emit(row)
    results["task_lt"] = row

    kernel_lt_encode(torch, a, plan, static_rows, results)
    del a, x, y_ref, plan, enc
    gc.collect()
    torch.cuda.empty_cache()


def _slab_fits(idx: np.ndarray, cof: np.ndarray, r: int, m: int) -> bool:
    """Whether lt_encode takes the table on its slab engine on this card."""
    import torch

    from repro_torch.kernels.lt_encode import _sm_count, lt_csr_host, lt_slab_plan

    csr = lt_csr_host(idx, cof, r)
    return csr.used is not None and lt_slab_plan(
        csr.order.numel(), csr.n_used, csr.cols.numel(), m,
        _sm_count(torch.cuda.current_device())) is not None


def device_ms(torch, fn, iters: int) -> float:
    """fn's device time a call: CUDA events around ``iters`` calls, or, for
    a call under a millisecond (whose host time may exceed it), replays of
    a CUDA graph of 20 calls, so the host is out of the reading."""
    if time_ms(torch, fn, 2, warmup=1) >= 1.0:
        return time_ms(torch, fn, iters, warmup=1)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(20):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    return time_ms(torch, graph.replay, max(2, iters // 4), warmup=1) / 20


def lt_check(torch, a, idx: np.ndarray, cof: np.ndarray, label: str, results: dict,
             timed: bool) -> dict:
    """lt_encode on A (on the card) and the table (idx, cof) against
    ref_lt_encode, bit for bit: the wrapper on the table on the card (its
    compaction there), ``encode_rows``' path (the CSR built on the host) and
    each engine that takes the table (the slab engine where the table and a
    slab fit, the L2 engine always).  With ``timed`` (a task's shape), also
    each engine's kernel alone on the CSR that torch.sparse.mm also gets,
    device time in turns with it (``engines``; the row's ``kernel_ms`` and
    ``library_ms`` are the picked engine's); the call as ``encode_rows``
    makes it (``ms``: the host CSR, its copy, the kernel), the host CSR's
    build and copy (``host_csr_ms``), the compaction on the card that
    ``lt_encode_cuda`` runs (``compaction_ms``) and the plain version
    beside them; the bound; the row is kept in
    ``results['lt_encode'][label]``.  Each output is freed before the next
    (a task's Â is up to 17.5 GB)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import (_lt_csr, _lt_launch, _sm_count, lt_csr_host,
                                               lt_encode_csr_cuda, lt_encode_cuda, lt_slab_plan)

    dev = torch.device("cuda")
    (r, m), (q, d_max) = a.shape, idx.shape
    i_t = torch.as_tensor(np.ascontiguousarray(idx), device=dev)
    c_t = torch.as_tensor(np.ascontiguousarray(cof), device=dev)
    csr = _lt_csr(i_t, c_t, r)
    nnz = int(csr.cols.numel())
    plan = None if csr.used is None else lt_slab_plan(q, csr.n_used, nnz, m,
                                                      _sm_count(dev.index or 0))
    picked = "l2" if plan is None else "slab"
    want = ref.ref_lt_encode(a, i_t, c_t)
    errs = {}
    for name, call in (("wrapper", lambda: lt_encode_cuda(a, i_t, c_t)),
                       ("host csr", lambda: lt_encode_csr_cuda(a, lt_csr_host(idx, cof, r).to(dev))),
                       *((eng, lambda eng=eng: _lt_launch(a, csr, engine=eng))
                         for eng in (("slab", "l2") if plan else ("l2",)))):
        got = call()
        torch.cuda.synchronize()
        errs[name] = max_err(torch, got, want)[0]
        del got
    del want
    row = {"phase": "kernel", "kernel": "lt_encode", "shape": label, "engine": picked,
           "a": [r, m], "q": q, "d_max": d_max, "nonzeros": nnz,
           "max_degree": int((cof != 0).sum(1).max()), "a_rows_used": csr.n_used,
           "slab_plan": None if plan is None else dataclasses.asdict(plan),
           "max_abs_err": max(errs.values()), "max_abs_err_by_call": errs,
           "tol": 0.0}  # the plain version's bits
    if timed:
        sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.cols.long(), csr.vals,
                                         size=(q, r), check_invariants=False)
        library = lambda: torch.sparse.mm(sparse, a)  # noqa: E731
        iters = 3 if q * m > 1e9 else 20
        row["engines"] = {}
        for eng in (("slab", "l2") if plan else ("l2",)):
            kernel = lambda eng=eng: _lt_launch(a, csr, engine=eng)  # noqa: E731
            turns = [device_ms(torch, fn, iters) for fn in (kernel, library, library, kernel)]
            row["engines"][eng] = {"kernel_ms": (turns[0] + turns[3]) / 2,
                                   "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
            row["engines"][eng]["ratio"] = (row["engines"][eng]["kernel_ms"]
                                            / row["engines"][eng]["library_ms"])
        row["kernel_ms"] = row["engines"][picked]["kernel_ms"]
        row["library_ms"] = row["engines"][picked]["library_ms"]
        row["library_call"] = "torch.sparse.mm(CSR generator [q, r], A), the same CSR"
        row["ms"] = time_ms(torch, lambda: lt_encode_csr_cuda(
            a, lt_csr_host(idx, cof, r).to(dev)), iters, warmup=1)

        def host_csr():
            lt_csr_host(idx, cof, r).to(dev)
            torch.cuda.synchronize()

        host_csr()
        t0 = time.perf_counter()
        for _ in range(iters):
            host_csr()
        row["host_csr_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        row["compaction_ms"] = time_ms(torch, lambda: _lt_csr(i_t, c_t, r), iters, warmup=1)
        row["plain_ms"] = time_ms(torch, lambda: ref.ref_lt_encode(a, i_t, c_t), 2, warmup=1)
        # each input read once: the rows of A the table references, the
        # padded table; the output written once
        n_bytes = 4 * row["a_rows_used"] * m + 8 * q * d_max + 4 * q * m
        row["bound_ms"], row["bound_by"] = bound(n_bytes, 2 * nnz * m)
        row["heavy_rows"] = csr.n_heavy
        # the same, had every nonzero entry to stream its row of A anew
        row["bound_no_reuse_ms"] = bound(n_bytes + 4 * (nnz - row["a_rows_used"]) * m, 0)[0]
        against_library(row, "kernel_ms")
        results.setdefault("lt_encode", {})[label] = row
        del sparse
    emit(row)
    check(row["max_abs_err"] == 0.0,
          f"lt_encode {label}: {errs} (not the plain version's bits)")
    del i_t, c_t, csr
    torch.cuda.empty_cache()
    return row


def kernel_lt_encode(torch, a_host, plan, static_rows: int, results: dict) -> None:
    """lt_encode on the card against ref_lt_encode, bit for bit: the task
    phase's own call (A [r, m], the whole plan: all of Â) and its reserve
    slice (the autotuner's LT cell and ``--sweep-lt``'s shape), each timed,
    and ragged shapes."""
    from repro_torch.core.encoding import LTCode
    from repro_torch.kernels.lt_encode import lt_encode_cuda

    dev = torch.device("cuda")
    a = torch.as_tensor(a_host, device=dev)
    lt_check(torch, a, plan.indices, plan.coeffs, "task", results, True)
    lt_check(torch, a, plan.indices[static_rows:], plan.coeffs[static_rows:],
             "task reserve slice", results, True)
    del a
    torch.cuda.empty_cache()
    gen = np.random.default_rng(7)
    # ragged: M % 4 != 0 (scalar loads); zeros mid-row with non-unit
    # coefficients and a degree-0 row; q = 1 with d_max = 1; rows of degree
    # over 64 (heavy units) across many 128-column spans
    lt = LTCode(300, seed=3).plan(420)
    lt_check(torch, torch.randn(300, 4097, device=dev), lt.indices[300:], lt.coeffs[300:],
             "ragged M % 4 != 0", results, False)
    idx = gen.integers(0, 200, (70, 9)).astype(np.int32)
    cof = gen.standard_normal((70, 9)).astype(np.float32)
    cof[gen.random((70, 9)) < 0.4] = 0.0
    cof[5] = 0.0
    lt_check(torch, torch.randn(200, 1030, device=dev), idx, cof, "ragged zeros mid-row",
             results, False)
    lt_check(torch, torch.randn(1 + 200 * 1032, device=dev)[1:].view(200, 1032), idx, cof,
             "ragged misaligned view", results, False)
    lt_check(torch, torch.randn(3, 4100, device=dev), np.array([[2]], np.int32),
             np.array([[0.5]], np.float32), "ragged q = 1, d_max = 1", results, False)
    idx = gen.integers(0, 500, (90, 200)).astype(np.int32)
    cof = gen.standard_normal((90, 200)).astype(np.float32)
    cof[gen.random((90, 200)) < 0.6] = 0.0
    lt_check(torch, torch.randn(500, 50_001, device=dev), idx, cof, "ragged heavy rows",
             results, False)
    lt_encode_cuda.launches = 0  # comparison launches are not the path's


def phase_task_gaussian(torch, args, results: dict, smi: str) -> None:
    """The task form with the Gaussian code at r = 500 (printed as a cut) and
    the paper's m, all of Â encoded by one gaussian_encode on the card; the
    host encode's run beside a device run at a narrower m; then
    gaussian_encode at the full run's shapes (the whole plan and its reserve
    slice)."""
    from repro_torch.cluster import ec2_scenario
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, gaussian_engine

    r_full, workers = ec2_scenario(2)
    r, m = r_full // 20, PAPER_M
    cut = {"r": r, "of_r": r_full,
           "reason": "r/20 as benchmarks/paper_ec2.py: the master's float64 least-squares "
                     "decode and the dense generator grow as r^2 to r^3 on the host"}
    emit({"phase": "cut", "task": "gaussian", **cut})
    pair_cut = {"same_trajectory_m": GAUSSIAN_PAIR_M, "of_m": m, "reason": PAIR_REASON}
    emit({"phase": "cut", "task": "gaussian", **pair_cut})
    t0 = time.perf_counter()
    a, x, y_ref = _task_inputs(torch, r, m, args.seed + 1)
    inputs_s = time.perf_counter() - t0
    dev_row, dev_res, em = _run_task(torch, a, x, y_ref, workers, "gaussian", "device",
                                     args.seed)
    enc = em.last_encode
    check(enc is not None, "no device encode ran")
    check(dev_res.ok and dev_row["max_rel_err"] <= 2e-3,
          f"Gaussian task rel err {dev_row['max_rel_err']}")
    check(enc["rows"] == dev_row["rows_assigned"],
          f"the encode made {enc['rows']} rows of {dev_row['rows_assigned']} assigned")
    q_all = enc["rows"]
    check(dev_row["launches"]["gaussian_encode"] == 1
          and dev_row["launches"]["gaussian_encode_wide"] == int(gaussian_engine(q_all) == "wide"),
          f"gaussian_encode launches {dev_row['launches']} for q = {q_all}")
    del dev_res
    t1 = time.perf_counter()
    pair = _trajectory_pair(torch, r, GAUSSIAN_PAIR_M, workers, "gaussian", args.seed,
                            args.seed + 1)
    row = {"phase": "task", "code": "gaussian", "scenario": 2, "r": r, "m": m,
           "cut": cut, "pair_cut": pair_cut, "workers": [w.name for w in workers],
           "time_scale": TASK_TIME_SCALE, "inputs_s": inputs_s,
           "static_rows": enc["static_rows"], "reserve_rows": enc["reserve_rows"],
           "device_encode": dev_row, "pair": pair,
           "same_trajectory": pair["same_trajectory"],
           "seconds": {"inputs": inputs_s, "device_run": dev_row["run_task_wall_s"],
                       "pair": time.perf_counter() - t1},
           "card": smi}
    emit(row)
    results["task_gaussian"] = row

    # gaussian_encode at the task's shapes: G [q, r] (the whole plan; its
    # reserve slice) x A, on the engine the wrapper picks and on the other
    # one, each timed in turns with torch.matmul and held to float64
    dev = torch.device("cuda")
    a_t = torch.as_tensor(a, device=dev)
    for label, g_host in (("task", enc["plan"].coeffs),
                          ("task reserve slice", enc["plan"].coeffs[enc["static_rows"]:])):
        g = torch.as_tensor(np.ascontiguousarray(g_host), device=dev)
        row = gaussian_row(torch, g, a_t, label, 20, f64=True)
        other = "register" if row["engine"] == "wide" else "wide"
        results.setdefault("gaussian_encode", {})[label] = row
        results["gaussian_encode"][f"{label} ({other})"] = gaussian_row(
            torch, g, a_t, f"{label} ({other})", 20, engine=other, f64=True)
        del g
    gaussian_encode_cuda.launches = 0
    del a_t
    torch.cuda.empty_cache()


EC2_ARGS = ["--scale", "40", "--trials", "2"]
EC2_BUDGET_S = 60.0   # the EC2 example phase's share of the smoke's 1,200 s


def phase_ec2_example(torch, args, results: dict, smi: str) -> None:
    """The paper's EC2 experiments 1 and 2 (Figs 8, 10) through the port's
    entry point ``examples/ec2_repro_torch.py`` at r/40, two trials a cell,
    the master's encode on the card: every task decodes, each coded task
    (hcmm, bpcc) launches lt_encode once and encodes every row it assigns,
    an uncoded one none; then lt_encode at the last coded task's shape, held
    to its plain version and timed.  The phase's seconds are held to a
    budget."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.kernels.lt_encode import lt_encode_cuda

    spec = importlib.util.spec_from_file_location(
        "ec2_repro_torch", os.path.join(HERE, "examples", "ec2_repro_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    out = io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(out):
        records = example.main(EC2_ARGS)
    launches = _launches()
    run_s = time.perf_counter() - t0
    coded = [rec for rec in records if rec["scheme"] in ("hcmm", "bpcc")]
    slab = sum(_slab_fits(rec["encode"]["plan"].indices, rec["encode"]["plan"].coeffs,
                          *rec["a_shape"]) for rec in coded)
    # every coded task's table on A of its shape, bit for bit; the last timed
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for i, rec in enumerate(coded):
        plan = rec["encode"]["plan"]
        a = torch.randn(*rec["a_shape"], device="cuda", generator=gen)
        last = i == len(coded) - 1
        lt_check(torch, a, plan.indices, plan.coeffs,
                 "ec2 example" if last else f"ec2 example task {i}", results, last)
    lt_encode_cuda.launches = 0
    del a, plan
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    row = {"phase": "ec2 example", "args": EC2_ARGS, "tables": out.getvalue().splitlines(),
           "tasks": len(records), "coded_tasks": len(coded),
           "all_ok": all(rec["ok"] for rec in records), "launches": launches,
           "encoded_rows": sum(rec["encode"]["rows"] for rec in coded),
           "encode_s": {k: sum(rec["encode"][k] for rec in coded)
                        for k in ("h2d_s", "encode_s", "d2h_s")},
           "run_s": run_s, "seconds": seconds, "budget_s": EC2_BUDGET_S,
           "within_budget": seconds <= EC2_BUDGET_S, "card": smi}
    emit(row)
    results["ec2 example"] = row
    check(row["all_ok"], "ec2 example: a task did not decode")
    check(launches["lt_encode"] == len(coded) and launches["lt_encode_slab"] == slab,
          f"ec2 example: {launches['lt_encode']} lt_encode launches "
          f"({launches['lt_encode_slab']} slab, {slab} expected) for {len(coded)} coded tasks")
    check(all(rec["encode"]["rows"] == rec["rows_assigned"] for rec in coded),
          "ec2 example: a coded task's encode did not make every row it assigned")
    check(all(rec["encode"] is None for rec in records if rec["scheme"] not in ("hcmm", "bpcc")),
          "ec2 example: an uncoded task ran an encode")
    check(row["within_budget"], f"ec2 example: {seconds} s over its {EC2_BUDGET_S} s")


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

    def make_engine(engine_params, mesh=None, **modes):
        modes = {"head_kernel_mode": "cuda", "encode_mode": "cuda", **modes}
        return ServeEngine(model, engine_params, n_slots=4, s_max=64, latency_fn=_stragglers(),
                           parity_controller=ParityController(16, decay=0.5),
                           parity_topup=1, topup_patience=2, mesh=mesh, device=dev, **modes)

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
    prefill_call_ms = time_ms(torch, lambda: eng._prefill1({"tokens": prompt}), 5)
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


def _timed_steps(torch, eng, rng, vocab: int, prompt_len: int, n_timed: int = 5,
                 req_kw: dict | None = None) -> float:
    """Mean ms of whole engine steps on a refilled queue, host clock: the
    first step admits every slot, each timed one decodes all of them
    (control plane, mask upload, model call, argmax and its host copy) and
    admits none.  ``req_kw``: more fields of each request (a vlm's image)."""
    from repro_torch.serve import Request

    for i in range(eng.n_slots):
        eng.submit(Request(uid=1000 + i, prompt=rng.integers(0, vocab, prompt_len),
                           max_new_tokens=32, **(req_kw or {})))
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
    mesh_ms, fused_ms, turns = time_turns(
        torch, lambda: ops.coded_head_matvec(placed, x, mask, 14, 2, mesh=mesh, kernel_mode="cuda"),
        lambda: ops.coded_head_matvec(wc, x, mask, 14, 2, kernel_mode="cuda"), 20)
    row = {"phase": "mesh_head_time", "b": 4, "erased": [5, 12], "mesh_ms": mesh_ms,
           "fused_ms": fused_ms, "turns_ms": turns,
           "launches": {name: launches[name] for name in ("coded_matvec", "coded_matvec_wide")},
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

    def make_engine(macro_steps=1):
        return ServeEngine(model, params, n_slots=4, s_max=MAMBA_S_MAX,
                           latency_fn=_stragglers(),
                           parity_controller=ParityController(16, decay=0.5), parity_topup=1,
                           topup_patience=2, head_kernel_mode="cuda", encode_mode="cuda",
                           ssd_kernel_mode="cuda", macro_steps=macro_steps, device=dev)

    eng = make_engine()
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
        prefill_ms[length] = time_ms(torch, lambda: eng._prefill1({"tokens": prompt}), 3, warmup=1)
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
    # the macro pair on the same engine factory
    prompts = [rng.integers(0, cfg.vocab, 100) for _ in range(4)]
    results[f"macro {arch}"] = phase_macro_pair(torch, make_engine, prompts, 64, cfg.name, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _step_bytes(eng) -> int:
    """Bytes a decode step must move: every layer weight and the coded head
    read once (the embedding and the uncoded head are not read), the cache
    read once, and the Mamba states and positions written once."""
    def nbytes(tree, skip=()):
        if isinstance(tree, dict):
            return sum(nbytes(v) for k, v in tree.items() if k not in skip)
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    def written(tree, name=""):
        if isinstance(tree, dict):
            return sum(written(v, k) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(written(v, name) for v in tree)
        return nbytes(tree) if name in ("ssm", "conv", "pos") else 0

    return (nbytes(eng.params, skip=("embed", "lm_head")) + nbytes(eng.cache)
            + written(eng.cache))


def phase_macro_pair(torch, make_engine, prompts, max_new: int, arch: str, smi: str,
                     req_kw: dict | None = None,
                     per_call: tuple = ("coded_matvec_decode",)) -> dict:
    """The workload through ``make_engine(1)`` (scalar steps) and
    ``make_engine(16)`` (fused blocks, one CUDA graph per K bucket), three
    waves of the same prompts on one engine.  Every wave is counted: equal
    tokens, ``coded_matvec_decode`` launches = prefills + steps + the
    captures' warm-up steps, the replays counted from their graphs' kernel
    nodes.  Wave 1 holds the captures (and the Mamba-2 engines' raise, after which the
    graphs are captured anew), wave 2 whatever bucket wave 1 did not reach
    after a raise, and wave 3 is timed and must capture nothing: its first
    step admits every slot and is not timed; the rest is ms per decoded
    step on the host clock (the device synchronized around it), host syncs
    per token and fused blocks.  Each capture's seconds (its warm-up step
    included) and the reserved bytes it adds (the graph pool) are read
    around it here.  ``req_kw``: more fields of every request (a vlm's
    image).  ``per_call``: the kernels every head call launches once, each
    held to that count (``masked_pinv`` too where the head decodes through
    ``svd_recovery``)."""
    from repro_torch.serve import Request

    runs = {}
    for k in (1, 16):
        eng = make_engine(k)
        captures = _measure_captures(torch, eng)
        waves = []
        for wave in range(3):
            uid0 = 100 * wave
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new,
                                   **(req_kw or {})))
            _reset_launches()
            steps0, syncs0, blocks0, tok0, caps0 = (eng._steps, eng.sync_count, eng.macro_blocks,
                                                    eng.tokens_emitted, len(eng.graph_log))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if wave:
                check(eng.step() == len(prompts), f"{arch} macro: wave 2 did not fill every slot")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            steps_t0 = eng._steps
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
            done = [r for r in eng.completed if uid0 <= r.uid < uid0 + len(prompts)]
            tokens = {r.uid - uid0: r.out_tokens for r in done}
            steps = eng._steps - steps0
            check(len(done) == len(prompts) and all(len(t) == max_new for t in tokens.values()),
                  f"{arch} macro K={k} wave {wave}: requests or token counts short")
            warmups = len(eng.graph_log) - caps0   # one eager step before each capture
            for name in per_call:
                check(launches[name] == len(prompts) + steps + warmups,
                      f"{arch} macro K={k} wave {wave}: {name} launches {launches} != "
                      f"{len(prompts)} prefills + {steps} steps + {warmups} warm-ups")
            waves.append({"tokens": tokens, "steps": steps, "wall_s": wall,
                          "ms_per_step": wall * 1e3 / max(eng._steps - steps_t0, 1),
                          "timed_steps": eng._steps - steps_t0,
                          "sync_count": eng.sync_count - syncs0,
                          "syncs_per_token": (eng.sync_count - syncs0)
                          / max(eng.tokens_emitted - tok0, 1),
                          "macro_blocks": eng.macro_blocks - blocks0, "launches": launches,
                          "captures": warmups,
                          "parity_events": len(eng.parity_events)})
        runs[k] = {"waves": waves, "graph_log": eng.graph_log, "captures": captures,
                   "graph_replays": eng.graph_replays,
                   "pool_bytes": sum(e["pool_bytes_added"] for e in captures),
                   # the device time of the 16-step graph alone, a step
                   "graph_device_ms_per_step": (time_ms(torch, eng._graphs[16].graph.replay, 5,
                                                        warmup=1) / 16
                                                if 16 in getattr(eng, "_graphs", {}) else None),
                   "step_bytes": _step_bytes(eng)}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    scalar, fused = runs[1], runs[16]
    for wave in range(3):
        check(fused["waves"][wave]["tokens"] == scalar["waves"][wave]["tokens"],
              f"{arch} macro wave {wave + 1}: fused (graph) tokens differ from scalar tokens")
    check(fused["waves"][2]["macro_blocks"] > 0 and fused["graph_log"],
          f"{arch} macro: no fused block ran")
    check(fused["waves"][2]["captures"] == 0, f"{arch} macro: the timed wave captured a graph")
    timed = [run["waves"][2] for run in (scalar, fused)]
    bound_ms = scalar["step_bytes"] / HBM_BYTES_PER_S * 1e3
    s_ms, f_ms = timed[0]["ms_per_step"], timed[1]["ms_per_step"]
    row = {"phase": "macro_serve", "arch": arch, "requests": len(prompts),
           "prompt_len": len(prompts[0]), "max_new": max_new,
           "scalar_ms_per_step": s_ms, "fused_ms_per_step": f_ms, "fused_over_scalar": f_ms / s_ms,
           "timed_steps": [w["timed_steps"] for w in timed],
           "sync_count": [w["sync_count"] for w in timed],
           "syncs_per_token": [w["syncs_per_token"] for w in timed],
           "macro_blocks": timed[1]["macro_blocks"],
           "wave1_ms_per_step": [scalar["waves"][0]["ms_per_step"],
                                 fused["waves"][0]["ms_per_step"]],
           "captures_per_wave": [w["captures"] for w in fused["waves"]],
           "graph_device_ms_per_step": fused["graph_device_ms_per_step"],
           "captures": [dict(e, launches_per_replay=g["launches_per_replay"])
                        for e, g in zip(fused["captures"], fused["graph_log"])],
           "graph_pool_bytes": fused["pool_bytes"], "graph_replays": fused["graph_replays"],
           "launches": [scalar["waves"][0]["launches"], fused["waves"][0]["launches"]],
           "parity_events": fused["waves"][0]["parity_events"],
           "step_bytes": scalar["step_bytes"], "step_bound_ms": bound_ms,
           "bound_share": [bound_ms / s_ms, bound_ms / f_ms],
           "tokens_equal": True, "card": smi}
    emit(row)
    return row


def _measure_captures(torch, eng) -> list:
    """Wrap ``eng``'s captures: for each, the seconds of its warm-up step
    and capture and the reserved bytes it adds, the device synchronized and
    the allocator's cache emptied before (the capture empties it as it
    starts, so the growth is the graph pool's).  Returns the list it
    fills, one entry a capture."""
    log = []
    capture = eng._capture

    def reserved() -> int:
        return torch.cuda.memory_stats().get("reserved_bytes.all.current", 0)

    def measured(k):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, t0 = reserved(), time.perf_counter()
        blk = capture(k)
        torch.cuda.synchronize()
        log.append({"k": k, "n_parity": eng.graph_log[-1]["n_parity"],
                    "capture_s": time.perf_counter() - t0, "pool_bytes_added": reserved() - r0})
        return blk

    eng._capture = measured
    return log


def phase_trace_serve(torch, args, serve: dict, results: dict, smi: str) -> None:
    """glm4-9b under open-loop traffic, driven as the launcher's trace mode
    drives it: a TraceScheduler over a Poisson trace at about 70 % offered
    load, deadline-aware parity over a HealthMonitor-fed latency stream with
    three persistent stragglers (one raise), fused blocks up to 16 steps."""
    from repro_torch.core.adaptive import DeadlineAwareParity, ParityController
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import HealthMonitor
    from repro_torch.serve import Request, ServeEngine, TraceScheduler, poisson_trace

    cfg = serve["cfg"]
    n_slots, n_req, prompt_len, max_new = 4, 12, 16, 64
    t_step = results["serve"]["step_ms"] / 1e3
    # the token draws do not depend on the rate: size the rate on them
    mk = lambda rate: poisson_trace(rate, n_req, seed=args.seed, mean_tokens=max_new,  # noqa: E731
                                    max_tokens=max_new, t_token=t_step, slo_factor=4.0)
    rate = 0.7 * n_slots / (float(mk(1.0).n_tokens.mean()) * t_step)
    trace = mk(rate)
    rng = np.random.default_rng(args.seed + 5)
    payloads = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, prompt_len),
                        max_new_tokens=int(trace.n_tokens[i])) for i in range(n_req)]
    sched = TraceScheduler(trace, n_slots, t_step_init=t_step, payloads=payloads)
    monitor = HealthMonitor(n_workers=16)

    def latency_fn():  # three persistent stragglers, seen through the monitor
        lat = 1e-3 * (1.0 + 0.1 * rng.random(16))
        lat[[2, 7, 11]] = 5e-2
        monitor.observe_step_latencies(lat)
        return monitor.shard_latencies()

    policy = DeadlineAwareParity(ParityController(16, decay=0.5))
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0  # noqa: E731
    eng = ServeEngine(build_model(cfg), serve["params"], n_slots=n_slots, s_max=96,
                      latency_fn=latency_fn, parity_policy=policy, parity_topup=1,
                      topup_patience=2, scheduler=sched, clock=clock, macro_steps=16,
                      head_kernel_mode="cuda", encode_mode="cuda", device=torch.device("cuda"))
    _reset_launches()
    t0 = time.monotonic()
    while not sched.finished:
        if eng.macro_step() == 0:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            time.sleep(max(0.0, nxt - clock()))
    torch.cuda.synchronize()
    wall = clock()
    launches = _launches()
    res = sched.results()
    done = np.isfinite(res["t_complete"])
    rejected = res["rejected"]
    n_tok = int(res["n_tokens"][done].sum())
    by_uid = {r.uid: r for r in eng.completed}
    row = {"phase": "trace_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "requests": n_req, "rate_per_s": rate, "t_token_est_s": t_step,
           "offered_load": rate * float(trace.n_tokens.mean()) * t_step / n_slots,
           "slo_factor": 4.0, "completed": int(done.sum()), "rejected": int(rejected.sum()),
           "slo_attainment": float(res["slo_met"].mean()),
           "est_step_ms": sched.est_step_time * 1e3, "wall_s": wall, "tokens": n_tok,
           "tokens_per_s": n_tok / wall, "decode_steps": eng._steps,
           "syncs_per_token": eng.sync_count / max(eng.tokens_emitted, 1),
           "fused_blocks": eng.macro_blocks,
           "captures": eng.graph_log,
           "parity_events": eng.parity_events, "launches": launches, "card": smi}
    emit(row)
    results["trace_serve"] = row
    check(bool((done | rejected).all()) and not bool((done & rejected).any()),
          "trace serve: a request neither completed nor was rejected")
    check(all(len(by_uid[i].out_tokens) == int(trace.n_tokens[i]) for i in np.flatnonzero(done)),
          "trace serve: a completed request missed its token budget")
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"trace serve: parity events {eng.parity_events}")
    check(eng.macro_blocks > 0 and eng.graph_replays == eng.macro_blocks,
          f"trace serve: {eng.macro_blocks} fused blocks, {eng.graph_replays} graph replays")
    warmups = len(eng.graph_log)  # one eager step before each capture
    check(launches["coded_matvec_decode"] == int(done.sum()) + eng._steps + warmups
          and launches["gaussian_encode"] == 1,
          f"trace serve launches {launches}: want {int(done.sum())} prefills + {eng._steps} "
          f"steps + {warmups} warm-ups and one raise")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_macro_glm(torch, serve: dict, results: dict, smi: str) -> None:
    """Phase 9: glm4-9b's macro pair under a fixed mask of two erasures."""
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServeEngine

    cfg = serve["cfg"]
    model = build_model(cfg)
    mask = np.ones(16)
    mask[[3, 12]] = 0.0

    def make_engine(macro_steps):
        return ServeEngine(model, serve["params"], n_slots=4, s_max=128, mask_fn=lambda: mask,
                           head_kernel_mode="cuda", macro_steps=macro_steps,
                           device=torch.device("cuda"))

    prompts = [serve["rng"].integers(0, cfg.vocab, 16) for _ in range(4)]
    results["macro glm4-9b"] = phase_macro_pair(torch, make_engine, prompts, 64, cfg.name, smi)


# the svd macro pairs' new tokens (phase 9 serves 64): at 32 the phase took
# 44.8-59.8 s on an H100 80GB HBM3 at 700 W, by its host's speed, at the
# edge of its budget
SVD_MAX_NEW = 16
SVD_BUDGET_S = 60.0    # the svd macro phase's share of the smoke's 1,200 s
SVD_ERASED = {(10, 6): (0, 3, 6, 9, 12, 15), (14, 2): (3, 12)}   # each pair's fixed mask
SVD_REPLACES = "none: jnp.linalg.pinv at src/repro/core/coded_ops.py:179"


def _all_masks(nb: int, n_parity: int, extra: int = 64, seed: int = 0) -> np.ndarray:
    """Every mask of at most n_parity erasures, then ``extra`` seeded masks
    of one erasure too many (the least-norm pseudo-inverse)."""
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


def _pinv_ops(nb: int, n: int) -> int:
    """float64 operations that rec = pinv(diag(m) B) diag(m) needs at the
    least, whatever the algorithm: forming the n x nb result from a
    factorization, a multiply and an add for each of its entries' n terms
    (no sweep, rotation or convergence test counted)."""
    return 2 * n * n * nb


def kernel_masked_pinv(torch, n_data: int, n_parity: int, label: str, smi: str) -> dict:
    """masked_pinv against ref_masked_pinv (float64 ``torch.linalg.pinv``)
    on every mask of at most n_parity erasures and 64 of one more, in one
    launch: each mask within 1e-6 of its own max|rec|, erased columns
    exactly 0, a second launch and
    each single-mask call bit-equal to the batch; then at the served mask
    (one mask, as every decode step launches it) timed in turns with
    ``torch.linalg.pinv`` of the masked generator (a yardstick: it syncs the
    host), beside the plain version, the device time of 20 launches in a
    CUDA graph a launch, the host time a call and the bound."""
    from repro_torch.core.coded_ops import _generator64
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_pinv import MAX_SWEEPS, masked_pinv_cuda

    dev = torch.device("cuda")
    nb = n_data + n_parity
    masks = torch.as_tensor(_all_masks(nb, n_parity), device=dev)
    gen = _generator64(nb, n_data, dev)
    sweeps = torch.zeros(len(masks), dtype=torch.int32, device=dev)
    got = masked_pinv_cuda(masks, gen, sweeps)
    again = masked_pinv_cuda(masks, gen)
    want = ref.ref_masked_pinv(masks, gen)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    tol = 1e-6 * want.abs().amax((1, 2))
    over_tol = float(((got - want).abs().amax((1, 2)) / tol).max())
    zero = not bool(got[(masks == 0)[:, None, :].expand_as(got)].any())
    singles = all(torch.equal(masked_pinv_cuda(masks[i].contiguous(), gen), got[i])
                  for i in range(0, len(masks), max(1, len(masks) // 16)))
    mask = torch.ones(nb, device=dev)
    mask[list(SVD_ERASED[(n_data, n_parity)])] = 0.0
    one_sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
    masked_pinv_cuda(mask, gen, one_sweeps)
    bm = gen * mask.double()[:, None]
    row = {"phase": "kernel", "kernel": "masked_pinv", "shape": label, "gen": [nb, n_data],
           "masks": len(masks), "erased": list(SVD_ERASED[(n_data, n_parity)]),
           "max_abs_err": err, "max_abs_rec": scale, "tol": "1e-6 x each mask's max|rec|",
           "max_err_over_tol": over_tol, "erased_columns_zero": zero,
           "bit_equal_relaunch": torch.equal(got, again), "bit_equal_single_calls": singles,
           "sweeps_max": int(sweeps.max()), "sweeps_mean": float(sweeps.float().mean()),
           "sweeps_served_mask": int(one_sweeps[0]), "card": smi}
    del got, again, want
    row["ms"], row["library_ms"], row["turns_ms"] = time_turns(
        torch, lambda: masked_pinv_cuda(mask, gen),
        lambda: torch.linalg.pinv(bm, rtol=1e-6), 50)
    row["library_call"] = "torch.linalg.pinv(diag(m) B, rtol=1e-6), float64 (yardstick; syncs)"
    row["plain_ms"] = time_ms(torch, lambda: ref.ref_masked_pinv(mask, gen), 50)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
        for _ in range(20):
            masked_pinv_cuda(mask, gen)
    row["device_ms"] = time_ms(torch, graph.replay, 10) / 20
    row["host_ms"] = host_ms(torch, lambda: masked_pinv_cuda(mask, gen))
    n_bytes = 4 * nb + 8 * nb * n_data + 4 * n_data * nb
    row["bound_ms"], row["bound_by"] = bound(n_bytes, _pinv_ops(nb, n_data), FP64_FLOPS)
    against_library(row)
    del graph
    emit(row)
    check(over_tol <= 1.0, f"masked_pinv {label}: a mask's error is {over_tol} x its tol")
    check(zero, f"masked_pinv {label}: an erased column is not zero")
    check(row["bit_equal_relaunch"] and singles, f"masked_pinv {label}: launches differ")
    check(row["sweeps_max"] < MAX_SWEEPS, f"masked_pinv {label}: a mask hit the sweep cap")
    return row


def phase_macro_svd(torch, serve: dict, results: dict, smi: str) -> None:
    """Phase 9b: fused blocks whose head decodes through ``svd_recovery``,
    its recovery matrix built by the ``masked_pinv`` kernel inside the CUDA
    graphs.  The kernel against its plain version at (10, 6) and (14, 2)
    (``kernel_masked_pinv``); the serve phase's head re-encoded on the card
    into (10, 6) as a parity raise does (``gaussian_encode``, then its
    coded_matvec_decode at B = 4 checked and timed); then two macro pairs as
    phase 9's: the (10, 6) head under six fixed erasures, and phase 9's
    (14, 2) head and mask with ``head_kernel_mode='svd'``; equal tokens,
    ``coded_matvec_decode`` and ``masked_pinv`` each launched once a head
    call."""
    from repro_torch.core.coded_ops import block_mds_generator, svd_recovery
    from repro_torch.kernels import ops, ref
    from repro_torch.models.registry import build_model
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = serve["cfg"]
    pinv_rows = {label: kernel_masked_pinv(torch, nd, npar, label, smi)
                 for label, nd, npar in (("glm4-9b (10, 6) head", 10, 6),
                                         ("glm4-9b (14, 2) svd", 14, 2))}
    results["masked_pinv"] = pinv_rows

    # the (10, 6) head, re-encoded on the card as ServeEngine._raise_parity does
    head = serve["params"]["lm_head"].T.to(torch.float32)
    _reset_launches()
    coded = ops.encode_blocks_device(head, 10, 6, mode="cuda")
    torch.cuda.synchronize()
    encode_launches = _launches()
    check(encode_launches["gaussian_encode"] == 1, f"(10, 6) encode launches {encode_launches}")
    br = coded.shape[0] // 16
    blocks = torch.zeros(10 * br, head.shape[1], device=dev)
    blocks[: head.shape[0]] = head
    g = block_mds_generator(16, 10, device=dev)
    enc_row = gaussian_row(torch, g, blocks.view(10, br * head.shape[1]), "glm4-9b (10, 6) encode",
                           10)
    del blocks
    results.setdefault("gaussian_encode", {})["glm4-9b (10, 6) encode"] = enc_row
    mask = torch.ones(16, device=dev)
    mask[list(SVD_ERASED[(10, 6)])] = 0.0
    rec = svd_recovery(mask, 10, 6)
    x = torch.randn(head.shape[1], 4, device=dev, generator=torch.Generator(device=dev).manual_seed(6))
    got = ops.coded_matvec_decode(coded, x, rec, mode="cuda")
    want = ref.ref_coded_matvec_decode(coded, x, rec)
    err, scale = max_err(torch, got, want)
    dec_row = {"phase": "kernel", "kernel": "coded_matvec_decode", "shape": "glm4-9b decode (10, 6)",
               "w": list(coded.shape), "b": 4, "erased": list(SVD_ERASED[(10, 6)]),
               "max_abs_err": err, "tol": 1e-4 * max(1.0, scale),
               "rel_err_uncoded": float((got[: head.shape[0]] - head @ x).abs().max())
               / float((head @ x).abs().max())}
    del got, want
    dec_row["ms"], dec_row["library_ms"], dec_row["turns_ms"] = time_turns(
        torch, lambda: ops.coded_matvec_decode(coded, x, rec, mode="cuda"),
        lambda: torch.matmul(coded, x), 20)
    dec_row["library_call"] = "torch.matmul(W_c, x), the block product alone (partial yardstick)"
    dec_row["plain_ms"] = time_ms(torch, lambda: ref.ref_coded_matvec_decode(coded, x, rec), 20)
    n_bytes = 4 * (coded.numel() + x.numel() + rec.numel() + 10 * br * 4)
    dec_row["bound_ms"], dec_row["bound_by"] = bound(
        n_bytes, 2 * coded.shape[0] * coded.shape[1] * 4 + 2 * 10 * 16 * br * 4)
    against_library(dec_row)
    emit(dec_row)
    check(err <= dec_row["tol"], f"coded_matvec_decode (10, 6): {err} > {dec_row['tol']}")
    check(dec_row["rel_err_uncoded"] <= 1e-3,
          f"the (10, 6) head under six erasures is {dec_row['rel_err_uncoded']} off the uncoded head")
    results["coded_matvec_decode"]["glm4-9b decode (10, 6)"] = dec_row
    del x, rec, head

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(4)]
    cfg6 = dataclasses.replace(cfg, coded_parity=6)
    model6 = build_model(cfg6)
    params6 = dict(serve["params"], lm_head_coded=coded)
    mask6 = np.ones(16)
    mask6[list(SVD_ERASED[(10, 6)])] = 0.0
    per_call = ("coded_matvec_decode", "masked_pinv")

    def make_10_6(macro_steps):
        return ServeEngine(model6, params6, n_slots=4, s_max=64, mask_fn=lambda: mask6,
                           head_kernel_mode="cuda", macro_steps=macro_steps, device=dev)

    pair_10_6 = phase_macro_pair(torch, make_10_6, prompts, SVD_MAX_NEW, "glm4-9b (10, 6)", smi,
                                 per_call=per_call)
    del params6, coded
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    mask2 = np.ones(16)
    mask2[list(SVD_ERASED[(14, 2)])] = 0.0

    def make_svd(macro_steps):
        return ServeEngine(model, serve["params"], n_slots=4, s_max=64, mask_fn=lambda: mask2,
                           head_kernel_mode="svd", macro_steps=macro_steps, device=dev)

    pair_svd = phase_macro_pair(torch, make_svd, prompts, SVD_MAX_NEW, "glm4-9b svd", smi,
                                per_call=per_call)
    seconds = time.perf_counter() - t_phase
    row = {"phase": "macro_svd", "encode_launches": encode_launches,
           "pairs": {name: {k: pair[k] for k in ("scalar_ms_per_step", "fused_ms_per_step",
                                                 "fused_over_scalar", "launches", "captures",
                                                 "graph_device_ms_per_step")}
                     for name, pair in (("(10, 6)", pair_10_6), ("svd", pair_svd))},
           "seconds": seconds, "budget_s": SVD_BUDGET_S, "within_budget": seconds <= SVD_BUDGET_S,
           "card": smi}
    emit(row)
    check(row["within_budget"], f"macro glm4-9b svd: {seconds} s over its {SVD_BUDGET_S} s")
    results["macro glm4-9b svd"] = {"(10, 6)": pair_10_6, "svd": pair_svd,
                                    "encode": {"launches": encode_launches}, "seconds": seconds}


WIDE_SLOTS = 64        # the wide glm4-9b phase's slots: x of 64 columns at every decode step
WIDE_MAX_NEW = 8


def phase_wide_glm(torch, args, serve: dict, mesh, results: dict, smi: str) -> None:
    """glm4-9b at 64 slots on the serve phase's params: a ServeEngine runs 64
    prompts of 16 tokens and 8 new tokens each through the (14, 2) -> (13,
    3) raise (the serve phase's stragglers and controller), every decode
    step one launch of coded_matvec_decode on the wide engine (x [4096,
    64]); launches = prefills + steps, the wide ones = steps.  Then the
    same engine on the 16-device head mesh, coded_matvec at 64 columns, 16
    launches a call, its tokens equal to the single device's.  Then the
    macro pair at 64 slots (scalar steps against CUDA-graph blocks, equal
    tokens, launches = prefills + steps + captures), and the head's ms a
    call at 64 slots against torch.matmul(W_c, x)."""
    from repro_torch.core.adaptive import ParityController
    from repro_torch.core.decoding import get_decoder_cache
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = serve["cfg"]
    model = build_model(cfg)
    rng = np.random.default_rng(args.seed + 64)
    prompt_len = 16
    prompts = [rng.integers(0, cfg.vocab, prompt_len) for _ in range(WIDE_SLOTS)]

    def make_engine(engine_mesh=None):
        return ServeEngine(model, serve["params"], n_slots=WIDE_SLOTS, s_max=64,
                           latency_fn=_stragglers(),
                           parity_controller=ParityController(16, decay=0.5), parity_topup=1,
                           topup_patience=2, mesh=engine_mesh, device=dev,
                           head_kernel_mode="cuda", encode_mode="cuda")

    runs = {}
    for where, engine_mesh in (("single device", None), ("mesh", mesh)):
        eng = make_engine(engine_mesh)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=WIDE_MAX_NEW))
        torch.cuda.reset_peak_memory_stats()
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
        check(len(done) == WIDE_SLOTS and all(len(t) == WIDE_MAX_NEW for t in tokens.values()),
              f"wide glm4-9b {where}: requests or token counts short")
        check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
              f"wide glm4-9b {where}: parity events {eng.parity_events}")
        if engine_mesh is None:
            check(launches["coded_matvec_decode"] == WIDE_SLOTS + steps
                  and launches["coded_matvec_decode_wide"] == steps
                  and launches["coded_matvec"] == 0,
                  f"wide glm4-9b: launches {launches} != {WIDE_SLOTS} prefills + {steps} "
                  f"steps, {steps} of them wide")
        else:
            check(launches["coded_matvec"] == 16 * (WIDE_SLOTS + steps)
                  and launches["coded_matvec_wide"] == 16 * steps
                  and launches["coded_matvec_decode"] == 0,
                  f"wide glm4-9b mesh: launches {launches} != 16 x ({WIDE_SLOTS} prefills + "
                  f"{steps} steps), 16 x {steps} wide")
        step_ms = _timed_steps(torch, eng, rng, cfg.vocab, prompt_len)
        runs[where] = {"tokens": tokens, "launches": launches, "decode_steps": steps,
                       "wall_s": wall, "tokens_per_s": n_tok / wall, "step_ms": step_ms,
                       "parity_events": eng.parity_events,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    equal = runs["mesh"]["tokens"] == runs["single device"]["tokens"]

    # the head alone at 64 slots, through the wrapper as a step calls it
    wc = serve["params"]["lm_head_coded"]
    x = torch.randn(cfg.d_model, WIDE_SLOTS, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(args.seed + 65))
    mask = torch.ones(16, device=dev)
    mask[[3, 12]] = 0.0
    rec = get_decoder_cache(14, 2).recovery(mask)
    head_ms, matmul_ms, turns = time_turns(
        torch, lambda: ops.coded_matvec_decode(wc, x, rec, mode="cuda"),
        lambda: torch.matmul(wc, x), 10)
    del x

    mask_np = np.ones(16)
    mask_np[[3, 12]] = 0.0

    def make_macro(macro_steps):
        return ServeEngine(model, serve["params"], n_slots=WIDE_SLOTS, s_max=64,
                           mask_fn=lambda: mask_np, head_kernel_mode="cuda",
                           macro_steps=macro_steps, device=dev)

    macro = phase_macro_pair(torch, make_macro, prompts, WIDE_MAX_NEW, f"{cfg.name} x{WIDE_SLOTS}",
                             smi)
    single = runs["single device"]
    row = {"phase": "wide_glm", "arch": cfg.name, "n_layers": cfg.n_layers, "n_slots": WIDE_SLOTS,
           "requests": WIDE_SLOTS, "prompt_len": prompt_len, "max_new": WIDE_MAX_NEW,
           "decode_steps": single["decode_steps"], "wall_s": single["wall_s"],
           "tokens_per_s": single["tokens_per_s"], "step_ms": single["step_ms"],
           "scalar_ms_per_step": macro["scalar_ms_per_step"],
           "fused_ms_per_step": macro["fused_ms_per_step"],
           "launches": single["launches"], "parity_events": single["parity_events"],
           "mesh": {k: runs["mesh"][k] for k in ("launches", "decode_steps", "step_ms",
                                                 "tokens_per_s", "wall_s")},
           "tokens_equal_mesh": equal,
           "head_ms": head_ms, "head_library_ms": matmul_ms, "head_turns_ms": turns,
           "head_library_call": "torch.matmul(W_c, x), the block product alone",
           "macro_launches": macro["launches"], "captures": macro["captures"],
           "peak_mem_gb": max(single["peak_mem_gb"], runs["mesh"]["peak_mem_gb"]), "card": smi}
    emit(row)
    results["wide glm4-9b"] = row
    results["wide glm4-9b mesh"] = runs["mesh"]
    results["macro glm4-9b x64"] = macro
    check(equal, "wide glm4-9b: the mesh engine's tokens differ from the single device's")


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


# --------------------------------------------------------------------------
# the moe, vlm and encdec serves
FAMILY_ARCHS = {"llama-3.2-vision-11b": "vlm", "dbrx-132b": "moe"}
VLM_PROMPTS = (8192, 1000, 100, 16, 16, 16)  # tokens of the six vlm requests
MOE_PROMPTS = VLM_PROMPTS[1:]                # the same mix without the 8192-token prompt
ENCDEC_PROMPTS = (1000, 100, 16, 16, 16, 16)
FAMILY_MAX_NEW = 8
GATE = 0.5          # every vlm cross-attention gate: at init tanh(0) = 0 hides the layer
MOE_LAYERS = 3      # dbrx-132b depth (of 40): 19.4 GB a layer with its fp32 leaves and
#                     their bf16 copy both resident, beside the fp32 embedding and heads
MACRO_S_MAX = 128   # the macro pairs' 16 prompt + 64 new tokens
ENCDEC_REL_TOL = 0.05   # decode vs forward, of max|logit| (tests/test_models.py:63)


def _stragglers():
    """A latency stream with three persistent stragglers: more than the
    coded head's budget of 2, so the parity controller raises once."""
    def latency_fn():
        lat = np.full(16, 1e-3)
        lat[2] = lat[7] = lat[11] = 5e-2
        return lat

    return latency_fn


def _init_served(torch, args, cfg, extra: dict) -> tuple:
    """The model and its seeded params on the card, with their init line."""
    from repro_torch.models.registry import build_model

    dev = torch.device("cuda")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "init_s": time.perf_counter() - t0,
          "param_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9,
          **extra})
    return model, params


def _served_run(torch, eng, reqs) -> tuple:
    """The requests through ``eng.run()``, the launch counts set to 0 just
    before: (completed requests, wall seconds, launches)."""
    for r in reqs:
        eng.submit(r)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, _launches()


def _check_served(done, cfg, n_req: int, what: str) -> dict:
    """Every request completed with its token count, in the vocabulary; the
    tokens by uid."""
    tokens = {r.uid: r.out_tokens for r in done}
    check(len(done) == n_req, f"{what}: {len(done)} of {n_req} requests completed")
    check(all(len(t) == FAMILY_MAX_NEW for t in tokens.values()), f"{what}: a request missed "
          "its token count")
    check(all(0 <= t < cfg.vocab for ts in tokens.values() for t in ts),
          f"{what}: token out of vocab")
    return tokens


def _sdpa_chunked_vs_dense(torch, q, k, v, causal: bool) -> dict:
    """Block 0's chunked SDPA against the dense ``_sdpa`` on the same q, k
    and v (upcast to fp32, so both compute in fp32 as the chunked loop
    does), one kv head's query group at a time (the dense logits of all 32
    heads at 8192 tokens would take 8.6 GB); within one bf16 step of
    max|dense|, the rounding of the chunked output."""
    from repro_torch.models import attention

    got = attention._sdpa_chunked(q, k, v, causal=causal)
    mask = attention._causal_mask5(q.shape[1], k.shape[1], q.device) if causal else None
    kvh = k.shape[2]
    gs = q.shape[2] // kvh
    err = scale = 0.0
    for g in range(kvh):
        dense = attention._sdpa(q[:, :, g * gs:(g + 1) * gs].float(),
                                k[:, :, g:g + 1].float(), v[:, :, g:g + 1].float(), mask)
        err = max(err, float((got[:, :, g * gs:(g + 1) * gs].float() - dense).abs().max()))
        scale = max(scale, float(dense.abs().max()))
        del dense
    ms = time_ms(torch, lambda: attention._sdpa_chunked(q, k, v, causal=causal), 2, warmup=1)
    return {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype).removeprefix("torch."),
            "max_abs_err": err, "tol": BF16_STEP * scale, "max_abs_dense": scale,
            "finite": bool(torch.isfinite(got).all()), "chunked_ms": ms}


def _moe_drops(seen: list) -> dict:
    """The share of (token, k) assignments dropped by capacity over the
    recorded ``moe_apply`` calls, at prefill (S > 1) and at decode."""
    from repro_torch.models.moe import route

    out = {}
    for phase, calls in (("prefill", [c for c in seen if c[1].shape[1] > 1]),
                         ("decode", [c for c in seen if c[1].shape[1] == 1])):
        dropped = total = 0
        caps = set()
        for p, x, kw in calls:
            r = route(p, x.reshape(-1, x.shape[-1]), top_k=kw["top_k"],
                      capacity_factor=kw["capacity_factor"],
                      dispatch_groups=kw["dispatch_groups"])
            dropped += int((~r.keep).sum())
            total += r.keep.numel()
            caps.add((x.shape[0] * x.shape[1], r.cap))
        out[phase] = {"calls": len(calls), "assignments": total, "dropped": dropped,
                      "dropped_share": dropped / max(total, 1),
                      "tokens_and_cap": sorted(caps)}
    return out


def _moe_vs_loop(torch, call) -> dict:
    """``moe_apply`` against ``moe_apply_loop`` (token by token, the same
    keep mask) at one recorded call's real input, bf16: within two bf16
    steps of max|loop| (the expert output's rounding and the combine's)."""
    from repro_torch.models.moe import moe_apply, moe_apply_loop, route

    p, x, kw = call
    y, _ = moe_apply(p, x, **kw)
    loop = moe_apply_loop(p, x, **kw)
    torch.cuda.synchronize()
    err, scale = max_err(torch, y.float(), loop.float())
    keep = route(p, x.reshape(-1, x.shape[-1]), top_k=kw["top_k"],
                 capacity_factor=kw["capacity_factor"], dispatch_groups=kw["dispatch_groups"]).keep
    return {"x": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
            "kept": int(keep.sum()), "assignments": keep.numel(), "max_abs_err": err,
            "tol": 2 * BF16_STEP * scale, "max_abs_loop": scale,
            "finite": bool(torch.isfinite(y).all())}


def phase_family_serve(torch, args, results: dict, smi: str, arch: str) -> None:
    """llama-3.2-vision-11b (vlm, whole: 40 layers, 8 of them with gated
    image cross-attention, every gate set to ``GATE``) or dbrx-132b (moe,
    full width, depth cut to ``MOE_LAYERS``, printed as a cut), coded head
    (14, 2), seeded init on the card: 4 slots, requests of ``VLM_PROMPTS``
    (vlm, each with a seeded image [1024, 4096]) or ``MOE_PROMPTS`` tokens
    and 8 new tokens each, the three persistent stragglers forcing the
    (13, 3) raise.  The vlm's 8192-token prompt runs ``_sdpa_chunked`` in
    every layer (and in its cross-attentions): the calls are counted, and
    block 0's is held to the dense ``_sdpa``.  The moe's ``moe_apply`` calls
    are recorded: the share of assignments dropped by capacity at prefill
    and at decode, and block 0's call against ``moe_apply_loop`` at the
    100-token prefill and the first B = 4 decode.  Then prefill ms per
    prompt length, whole steps, and the macro pair (four requests of 16
    prompt tokens and 64 new tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.core.adaptive import ParityController
    from repro_torch.models import attention, transformer
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    full = get_config(arch)
    vlm = full.family == "vlm"
    cfg = full.scaled(coded=True, coded_parity=2)
    if not vlm:
        cfg = cfg.scaled(n_layers=MOE_LAYERS)
        emit({"phase": "cut", "arch": arch, "n_layers": MOE_LAYERS, "of": full.n_layers,
              "reason": "a layer's 16 experts take 13.0 GB in fp32 and 6.5 GB as the serving "
                        "bf16 copy, both resident while the engine prepares them; widths "
                        "are not cut"})
    prompt_lens = VLM_PROMPTS if vlm else MOE_PROMPTS
    s_max = max(prompt_lens) + FAMILY_MAX_NEW
    extra = ({"cross_attn_layers": cfg.n_layers // cfg.cross_attn_every, "gate": GATE,
              "img_tokens": cfg.img_tokens} if vlm else
             {"n_experts": cfg.n_experts, "top_k": cfg.top_k, "d_ff": cfg.d_ff,
              "capacity_factor": cfg.capacity_factor})
    model, params = _init_served(torch, args, cfg, extra)
    if vlm:
        for name, sub in params["blocks"].items():
            if name.startswith("xattn_"):
                sub["gate"].fill_(GATE)
    phase_head(torch, params, cfg, torch.Generator(device=dev).manual_seed(args.seed + 1))

    def make_engine(engine_params, macro_steps=1, s_max=s_max):
        return ServeEngine(model, engine_params, n_slots=4, s_max=s_max,
                           latency_fn=_stragglers(),
                           parity_controller=ParityController(16, decay=0.5), parity_topup=1,
                           topup_patience=2, head_kernel_mode="cuda", encode_mode="cuda",
                           macro_steps=macro_steps, device=dev)

    eng = make_engine(params)
    del params  # the engine keeps the bf16 layer weights and the fp32 embedding and heads
    gc.collect()
    torch.cuda.empty_cache()
    served = dict(eng.params)  # with the (14, 2) head, for the macro pair
    rng = np.random.default_rng(args.seed + 20)

    def req_kw():
        if not vlm:
            return {}
        return {"img_embed": rng.standard_normal((cfg.img_tokens, cfg.d_model),
                                                 dtype=np.float32)}

    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=FAMILY_MAX_NEW,
                    **req_kw()) for i, n in enumerate(prompt_lens)]
    seen_chunked, seen_moe = [], []
    real_chunked, real_moe = attention._sdpa_chunked, transformer.moe_apply

    def chunked(q, k, v, **kw):  # block 0's arguments, then each call's kind
        seen_chunked.append(kw["causal"] if seen_chunked else (q, k, v, kw["causal"]))
        return real_chunked(q, k, v, **kw)

    def moe(p, x, **kw):
        seen_moe.append((p, x, kw))
        return real_moe(p, x, **kw)

    attention._sdpa_chunked, transformer.moe_apply = chunked, moe
    try:
        done, wall, launches = _served_run(torch, eng, reqs)
    finally:
        attention._sdpa_chunked, transformer.moe_apply = real_chunked, real_moe
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, n_req = eng._steps, len(prompt_lens)
    tokens = _check_served(done, cfg, n_req, arch)
    check(len(eng.parity_events) == 1 and eng.parity_events[0]["n_parity"] == 3,
          f"{arch}: parity events {eng.parity_events}")
    br13 = -(-cfg.vocab // 13)
    check(tuple(eng.params["lm_head_coded"].shape) == (16 * br13, cfg.d_model),
          f"{arch}: head not re-split to (13, 3)")
    check(launches["coded_matvec_decode"] == n_req + steps and launches["gaussian_encode"] == 1,
          f"{arch}: head launches {launches} ({n_req} prefills + {steps} steps, one raise)")
    row = {"phase": "serve", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "n_slots": 4, "s_max": s_max, "requests": n_req, "prompt_lens": prompt_lens,
           "max_new": FAMILY_MAX_NEW, "tokens": sum(len(t) for t in tokens.values()),
           "decode_steps": steps, "wall_s": wall}
    row["tokens_per_s"] = row["tokens"] / wall
    if vlm:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        kinds = [seen_chunked[0][3]] + seen_chunked[1:]
        check(kinds.count(True) == cfg.n_layers and kinds.count(False) == n_cross,
              f"{arch}: _sdpa_chunked ran {kinds.count(True)} causal and {kinds.count(False)} "
              f"cross calls, want {cfg.n_layers} and {n_cross} (the 8192-token prompt)")
        row["sdpa_chunked_calls"] = {"self": cfg.n_layers, "cross": n_cross}
        row["block0_sdpa_chunked_vs_dense"] = _sdpa_chunked_vs_dense(torch, *seen_chunked[0])
    else:
        row["moe_drops"] = _moe_drops(seen_moe)
        row["block0_moe_vs_loop"] = {
            "prefill 100": _moe_vs_loop(torch, next(c for c in seen_moe if c[1].shape[1] == 100)),
            "decode B=4": _moe_vs_loop(torch, next(c for c in seen_moe if c[1].shape[1] == 1))}
    del seen_chunked, seen_moe
    gc.collect()

    # after the counted run: the prefill call (B = 1) per prompt length, by
    # CUDA events, then whole engine steps on a refilled queue
    prefill_ms = {}
    for length in sorted(set(prompt_lens), reverse=True):
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, length)), device=dev)}
        if vlm:
            batch["img_embed"] = torch.as_tensor(req_kw()["img_embed"][None], device=dev)
        prefill_ms[length] = time_ms(torch, lambda: eng._prefill1(batch),
                                     2 if length > 4096 else 3, warmup=1)
    row.update(prefill_call_ms=prefill_ms,
               step_ms=_timed_steps(torch, eng, rng, cfg.vocab, 16, req_kw=req_kw()),
               sync_count=eng.sync_count, parity_events=eng.parity_events, launches=launches,
               peak_mem_gb=peak_gb, card=smi, first_tokens=tokens[0])
    emit(row)
    results[f"serve {arch}"] = row
    if vlm:
        r = row["block0_sdpa_chunked_vs_dense"]
        check(r["finite"] and r["max_abs_err"] <= r["tol"],
              f"{arch}: block 0's _sdpa_chunked differs from the dense _sdpa by "
              f"{r['max_abs_err']} (allowed {r['tol']})")
    else:
        for label, r in row["block0_moe_vs_loop"].items():
            check(r["finite"] and r["max_abs_err"] <= r["tol"],
                  f"{arch}: block 0's moe_apply ({label}) differs from its per-token loop by "
                  f"{r['max_abs_err']} (allowed {r['tol']})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    prompts = [rng.integers(0, cfg.vocab, 16) for _ in range(4)]
    results[f"macro {arch}"] = phase_macro_pair(
        torch, lambda k: make_engine(served, k, MACRO_S_MAX), prompts, 64, cfg.name, smi,
        req_kw=req_kw())
    del served
    gc.collect()
    torch.cuda.empty_cache()


def phase_encdec_serve(torch, args, results: dict, smi: str) -> None:
    """seamless-m4t-large-v2 whole (24 encoder + 24 decoder layers), seeded
    init on the card, served through the engine as the reference serves it:
    zero source frames of each prompt's length and the uncoded head (the
    reference's encdec makes no coded head), so this path runs no TPU
    kernel, and the phase checks that none launched.  4 slots, requests of
    ``ENCDEC_PROMPTS`` tokens and 8 new tokens.  Then, since zero frames
    give a zero encoder memory, a prefill and a decode step from seeded
    frames: decode within ``ENCDEC_REL_TOL`` of ``encdec_forward`` at the
    next position."""
    from repro_torch.configs import get_config
    from repro_torch.models.encdec import encdec_forward
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config("seamless-m4t-large-v2")
    model, params = _init_served(torch, args, cfg, {"enc_layers": cfg.enc_layers,
                                                     "head": "uncoded, as the reference's"})
    s_max = max(ENCDEC_PROMPTS) + FAMILY_MAX_NEW
    eng = ServeEngine(model, params, n_slots=4, s_max=s_max, device=dev)
    del params
    rng = np.random.default_rng(args.seed + 30)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=FAMILY_MAX_NEW)
            for i, n in enumerate(ENCDEC_PROMPTS)]
    done, wall, launches = _served_run(torch, eng, reqs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = _check_served(done, cfg, len(reqs), cfg.name)
    check(not any(launches.values()), f"{cfg.name}: a kernel launched on the encdec path "
          f"{launches}")
    prefill_ms = {}
    for length in sorted(set(ENCDEC_PROMPTS), reverse=True):
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (1, length)), device=dev),
                 "frames": torch.zeros((1, length, cfg.d_model), device=dev)}
        prefill_ms[length] = time_ms(torch, lambda: eng._prefill1(batch), 3, warmup=1)
    step_ms = _timed_steps(torch, eng, rng, cfg.vocab, 16)

    # seeded frames: decode after a 64-token prefix against the forward
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    frames = torch.randn(1, 512, cfg.d_model, device=dev, generator=gen)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 65)), device=dev)
    _, cache = model.prefill(eng.params, {"tokens": toks[:, :64], "frames": frames}, s_max=72)
    logits, _ = model.decode_step(eng.params, cache, toks[:, 64])
    hidden = encdec_forward(eng.params, cfg, frames, toks)
    want = hidden[:, -1].float() @ eng.params["lm_head"].float()
    torch.cuda.synchronize()
    err, scale = max_err(torch, logits, want)
    seeded = {"frames": list(frames.shape), "prefix": 64, "rel_err": err / scale,
              "tol": ENCDEC_REL_TOL, "finite": bool(torch.isfinite(logits).all()),
              "cross_kv_nonzero": bool(cache["ck"].any()),
              "argmax_equal": bool((logits.argmax(-1) == want.argmax(-1)).all())}
    row = {"phase": "serve", "arch": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "n_slots": 4, "s_max": s_max,
           "requests": len(reqs), "prompt_lens": ENCDEC_PROMPTS, "max_new": FAMILY_MAX_NEW,
           "tokens": sum(len(t) for t in tokens.values()), "decode_steps": eng._steps,
           "wall_s": wall, "tokens_per_s": sum(len(t) for t in tokens.values()) / wall,
           "prefill_call_ms": prefill_ms, "step_ms": step_ms, "sync_count": eng.sync_count,
           "launches": launches, "tpu_kernels": "none: the reference's encdec head is uncoded",
           "seeded_frames_decode_vs_forward": seeded, "peak_mem_gb": peak_gb, "card": smi,
           "first_tokens": tokens[0]}
    emit(row)
    results[f"serve {cfg.name}"] = row
    check(seeded["finite"] and seeded["cross_kv_nonzero"] and seeded["rel_err"] <= ENCDEC_REL_TOL,
          f"{cfg.name}: decode from seeded frames differs from the forward by "
          f"{seeded['rel_err']} of max|logit| (allowed {ENCDEC_REL_TOL})")
    del eng, cache, hidden
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the dry run on the card
# (cell, arch, shape, coded, batch cut to (None: no cut), why)
DRYRUN_CELLS = (
    ("dryrun-glm4-9b-decode_32k-coded", "glm4-9b", "decode_32k", True, 8,
     "device memory: the KV cache is 171.8 GB at batch 128 and 10.7 GB at 8, beside 37.6 GB "
     "of fp32 params"),
    ("dryrun-mamba2-130m-decode_32k-coded", "mamba2-130m", "decode_32k", True, None, None),
    ("dryrun-zamba2-1.2b-prefill_32k", "zamba2-1.2b", "prefill_32k", False, 1,
     "device memory: the activations of 32 prompts of 32,768 tokens"),
    ("dryrun-mamba2-130m-train_4k", "mamba2-130m", "train_4k", False, 8,
     "device memory: the activations of 256 sequences of 4,096 tokens in one microbatch"),
)
DRYRUN_STEPS = 3          # timed calls of each cell's function, after one warm-up
DRYRUN_HEAD_TOL = 1e-3    # a decode cell's logits against the plain head's, of max|logit|


def _dryrun_brief(row: dict) -> dict:
    """A dry-run row as printed beside its card run."""
    rl = row["roofline"]
    return {"multi_pod": row["multi_pod"], "chips": row["chips"], "memory": row["memory"],
            "flops": row["cost"]["flops"], "hbm_bytes": row["cost"]["hbm_bytes"],
            "bound_s": max(rl["compute_s"], rl["memory_s"]), "dominant": rl["dominant"],
            "mfu_bound": rl["mfu_bound"], "count_s": row["count_s"]}


def _expected_launches(cfg, kind: str, calls: int, batch: int) -> dict:
    """Every kernel's launches in ``calls`` calls of a dryrun cell's
    function: the coded head's decode kernel once a call (decode; on the
    wide engine from WIDE_MIN_B columns of x), each Mamba block's SSD pair
    once a prefill, and twice a train step (its forward and the
    checkpoint's recompute; one microbatch); none of the others."""
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    want = dict.fromkeys(_launches(), 0)
    if kind == "decode" and cfg.coded:
        want["coded_matvec_decode"] = calls
        want["coded_matvec_decode_wide"] = calls if batch >= WIDE_MIN_B else 0
    if cfg.family in ("ssm", "hybrid") and kind != "decode":
        per = cfg.n_layers * (2 if kind == "train" else 1)
        want["ssd_chunk"] = want["ssd_combine"] = calls * per
    return want


def phase_dryrun(torch, args, results: dict, smi: str) -> None:
    """The dry run (``repro_torch.launch.dryrun``): its ``--dry-run``
    listing, the reckoned rows (both meshes, HW_H100) of four cells at their
    assigned workload, and each cell's function run on the card at the cut
    workload with arguments of the same shapes made there: their bytes
    equal to the 1 x 1 reckoning, the peak, the median step against the
    roofline's bound, the kernels launched."""
    import contextlib
    import io

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.utils.hlo import HW_H100
    from repro_torch.utils.tree import tree_flatten_with_path

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(["--dry-run", "--multi-pod", "both"])
    listing = buf.getvalue()
    print(listing, end="", flush=True)
    check("--dry-run: 64 compilable cells resolved" in listing,
          "the dry run's listing does not resolve 64 cells")
    one = make_mesh((1, 1), ("data", "model"))
    for label, arch, shape, coded, cut_batch, why in DRYRUN_CELLS:
        t0 = time.perf_counter()
        cfg, wl = get_config(arch), SHAPES[shape]
        rows = dryrun.run_cells(arch, shape, (False, True), coded=coded)
        for r in rows:
            check(r["status"] == "ok", f"{label}: dry-run row {r.get('error')}")
        cut = None
        if cut_batch is not None:
            cut = {"batch": cut_batch, "of_batch": wl.batch, "reason": why}
            emit({"phase": "cut", "cell": label, **cut})
            wl = dataclasses.replace(wl, batch=cut_batch)
        reckoned, rl = dryrun.reckon(cfg, wl, one, coded=coded)
        count_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 23)
        fn, cell_args, meta = dryrun.build_cell(cfg, wl, one, coded=coded, device="cuda",
                                                generator=gen)
        arg_bytes = sum(x.numel() * x.element_size()
                        for a in cell_args for _, x in tree_flatten_with_path(a))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        check(arg_bytes == reckoned["memory"]["argument_size_in_bytes"],
              f"{label}: {arg_bytes} argument bytes on the card, "
              f"{reckoned['memory']['argument_size_in_bytes']} reckoned")

        t2 = time.perf_counter()
        _reset_launches()
        out = fn(*cell_args)  # warm-up
        steps_ms = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(DRYRUN_STEPS):
            del out
            start.record()
            out = fn(*cell_args)
            stop.record()
            torch.cuda.synchronize()
            steps_ms.append(start.elapsed_time(stop))
        launches = _launches()
        run_s = time.perf_counter() - t2
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        step_ms = float(np.median(steps_ms))
        want = _expected_launches(meta["cfg"], wl.kind, DRYRUN_STEPS + 1, wl.batch)

        # what came out: finite, of the expected shape; a decode cell's
        # coded head against the plain head on the same step
        outcome: dict = {}
        if wl.kind == "train":
            metrics = out[1]
            outcome = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
            ok = all(np.isfinite(v) for v in outcome.values())
        else:
            logits = out[0]
            ok = (tuple(logits.shape) == (wl.batch, cfg.vocab)
                  and bool(torch.isfinite(logits).all()))
            outcome = {"logits_shape": list(logits.shape), "finite": ok}
            if wl.kind == "decode":
                model = build_model(meta["cfg"])
                with torch.no_grad():
                    plain = model.decode_step(*cell_args, head_kernel_mode="off")[0]
                err, scale = max_err(torch, logits, plain)
                outcome.update(head_vs_plain_max_abs_err=err, max_abs_logit=scale,
                               tol=DRYRUN_HEAD_TOL * scale)
                ok = ok and err <= DRYRUN_HEAD_TOL * scale
                del plain
        row = {"phase": "dryrun", "cell": label, "arch": arch, "shape": shape, "coded": coded,
               "workload": {"kind": wl.kind, "seq": wl.seq, "batch": wl.batch}, "batch_cut": cut,
               "dryrun_rows": [_dryrun_brief(r) for r in rows],
               "reckoned_1x1": {"memory": reckoned["memory"], "flops": reckoned["cost"]["flops"],
                                "flops_by_dtype": reckoned["cost"]["flops_by_dtype"],
                                "hbm_bytes": reckoned["cost"]["hbm_bytes"],
                                "model_flops": reckoned["roofline"]["model_flops"]},
               "arg_bytes_card": arg_bytes,
               "arg_bytes_reckoned": reckoned["memory"]["argument_size_in_bytes"],
               "peak_allocated_gb": peak_gb, "step_ms": step_ms, "steps_ms": steps_ms,
               "bound_ms": rl.bound_s * 1e3, "bound_by": rl.dominant,
               "share_of_bound": rl.bound_s * 1e3 / step_ms,
               "mfu": reckoned["roofline"]["model_flops"] / (HW_H100.peak_flops
                                                            * step_ms / 1e3),
               "launches": launches, "launches_expected": want, "outcome": outcome,
               "seconds": {"count": count_s, "build": build_s, "run": run_s}, "card": smi}
        emit(row)
        results[label] = row
        check(ok, f"{label}: the step's output is wrong: {outcome}")
        check(launches == want, f"{label}: launches {launches}, expected {want}")
        del fn, cell_args, meta, out
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# training
TRAIN_GLM_LAYERS = 2      # glm4-9b train depth (of 40): the cut
TRAIN_BATCH, TRAIN_MICRO = 8, 4
TRAIN_GLM_SEQ, TRAIN_ZAMBA_SEQ, TRAIN_DRILL_SEQ = 512, 1024, 512
TRAIN_STEPS = 10          # glm4-9b: 10 plain and 10 FRC steps
TRAIN_ZAMBA_STEPS = 6     # zamba2-1.2b's timed launcher run (the first step is not timed)
TRAIN_ZAMBA_LAYERS = 18   # zamba2-1.2b train depth (of 38): three periods of its shared attention
TRAIN_ADAPTIVE_STEPS = 3  # zamba2-1.2b's short run under --adaptive-s
TRAIN_LR = 1e-4           # peak lr of the full-width phases (warmup-cosine)
# a coded step against the plain step from the same state, both on the card:
# the same per-microbatch losses and gradients, summed in another order in
# fp32 (FRC: group sums, then the decode), so the loss within 1e-5 relative
# and each gradient leaf within 1e-4 of its max (the CPU differential tests'
# bounds)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4


def _state_gb(tree) -> float:
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9


def _moment_gb(params, moment_dtype: str) -> float:
    """One moment tree's bytes: 4 (fp32) or 2 (bf16) a parameter, or int8
    codes and one fp32 scale a trailing row (``optim/quant.py``)."""
    from repro_torch.utils.tree import tree_leaves

    n = 0
    for t in tree_leaves(params):
        if moment_dtype == "int8":
            n += t.numel() + 4 * (t.numel() // t.shape[-1] if t.dim() else 1)
        else:
            n += t.numel() * (4 if moment_dtype == "float32" else 2)
    return n / 1e9


def _train_memory(params, m: int, compress: bool, coded: bool = True,
                  moment_dtype: str = "float32") -> dict:
    """What a step keeps on the card at its two peaks, reckoned from the
    code (``train/loop.py``, ``optim/adamw.py``); activations not counted.
    The last microbatch's backward: params, both moments, that microbatch's
    fp32 gradients, and the m fp32 messages (coded) or the fp32 accumulator
    (plain, m > 1), with compression the residual.  The update: the given
    params and moments beside the new ones (the gradients are released as
    the new leaves are made), with compression the old residual beside the
    new one (written into the message buffers)."""
    p = _state_gb(params)   # fp32 params; a gradient tree takes as much
    mom = 2 * _moment_gb(params, moment_dtype)
    agg = m * p if coded else (p if m > 1 else 0.0)
    err = m * p if compress else 0.0
    out = {"params_gb": p, "moments_gb": mom, "moment_dtype": moment_dtype, "grads_gb": p,
           ("messages_gb" if coded else "accumulator_gb"): agg, "err_gb": err,
           "backward_gb": 2 * p + mom + agg + err, "update_gb": 2 * (p + mom + err)}
    out["total_gb"] = max(out["backward_gb"], out["update_gb"])
    return out


def _profile_one(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler, tracing the device only: its
    wall ms, the device's kernel time and its busy share of the wall,
    kernel launches; with the profiler on (the caller adds the device time
    over the unprofiled step's wall, ``device_ms_over_step_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_evts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_evts) / 1e3
    top = sorted(dev_evts, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": busy, "busy_share": busy / wall_ms,
            "launches": sum(e.count for e in dev_evts),
            "top": [{"kernel": e.key[:80], "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def _timed_train(torch, step, box: dict, pipe, first: int, n: int, mask_fn) -> tuple:
    """``n`` steps from ``box["state"]``, which each step replaces (the box
    holds the only reference, so no older state outlives its step); per
    step its ms (host clock, the device synchronized around it) and loss.
    Returns (ms list, loss list)."""
    ms, losses = [], []
    for i in range(first, first + n):
        mask = mask_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["state"], met = step(box["state"], pipe.batch(i),
                                 *(() if mask is None else (mask,)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        check(np.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
        if mask is not None:
            check(float(met["ok"]) == 1.0, f"train step {i}: a decodable mask gave ok = 0")
    return ms, losses


def _grads_close(torch, got: list, want: list, what: str) -> float:
    """Worst |got - want| of two gradients (leaf lists; ``want`` on the
    host, each leaf to the card in turn) over each leaf's max|want|; fails
    above TRAIN_GRAD_TOL."""
    worst = 0.0
    for a, b in zip(got, want):
        b = b.to(a.device)
        worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    check(worst <= TRAIN_GRAD_TOL, f"{what}: gradient off by {worst} of a leaf's max "
                                   f"(allowed {TRAIN_GRAD_TOL})")
    return worst


def _coded_step_checks(torch, what: str, plain, coded, state0, batch0, decodable,
                       undecodable) -> dict:
    """From one state and batch: the plain step's loss and gradient (read
    by ``step.gradients``, the step without its update, so the check does
    not depend on the moments' dtype), then the coded step's under each
    decodable mask (ok = 1, the loss within TRAIN_LOSS_RTOL of the plain
    step's, each gradient leaf within TRAIN_GRAD_TOL of its max), and the
    whole coded step under an undecodable mask (ok = 0, params and
    optimizer state bit-equal to the state it was given).  The plain
    gradient waits on the host while the coded steps run."""
    from repro_torch.utils.tree import tree_leaves

    dev = tree_leaves(state0["params"])[0].device
    loss, _, grads, _, _ = plain.gradients(state0, batch0)
    g_plain, loss_plain = [g.cpu() for g in grads], float(loss)
    del grads
    torch.cuda.empty_cache()
    checks = {}
    for mask in decodable:
        label = "all ones" if min(mask) == 1.0 else f"mask {mask}"
        loss, _, grads, _, ok = coded.gradients(state0, batch0, torch.tensor(mask, device=dev))
        rel = abs(float(loss) - loss_plain) / abs(loss_plain)
        check(float(ok) == 1.0, f"{what}: under {label} ok = 0")
        check(rel <= TRAIN_LOSS_RTOL, f"{what}: {label} loss off the plain by {rel}")
        checks[label] = {"loss_rel_err": rel,
                         "grad_rel_err": _grads_close(torch, grads, g_plain, f"{what} {label}")}
        del grads
        torch.cuda.empty_cache()
    del g_plain
    sk, mk = coded(state0, batch0, torch.tensor(undecodable, device=dev))
    kept = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(sk["params"]) + tree_leaves(sk["opt"]),
                   tree_leaves(state0["params"]) + tree_leaves(state0["opt"])))
    checks[f"undecodable {undecodable}"] = {"ok": float(mk["ok"]), "state_bit_equal": kept}
    check(float(mk["ok"]) == 0.0 and kept,
          f"{what}: the undecodable mask {undecodable} changed the state (ok {float(mk['ok'])})")
    del sk, mk
    return checks


LR_LINE = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3)   # the steps t along Adam's first update
FD_TOL = 1e-2   # central difference vs <g, u>, relative (fp32; about 1e-4 expected)


def _lr_line(torch, cfg, state0, batch0, batch1, opt) -> dict:
    """Why the full-width loss rises above lr ~1e-4: the loss along AdamW's
    first update from ``state0``, in fp32 activations.  g is the gradient
    of ``batch0``'s loss, u = (AdamW's new params - params) / lr, and the
    losses of ``batch0`` (the step's own) and of ``batch1`` (the next
    step's) are read at p + t u for each t of LR_LINE, with u whole, u on
    the head alone and u on every other leaf.  The gradient at full width
    is held to a central difference of ``batch0``'s loss along u (FD_TOL):
    a port fault in the loss or its gradient would show there, the
    optimizer's step length would not."""
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_update
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    model = build_model(cfg.scaled(dtype="float32"))
    params = state0["params"]
    leaves = tree_leaves(params)
    is_head = [t is params["lm_head"] for t in leaves]
    batch, nxt = ({k: torch.as_tensor(v, device=leaves[0].device).long() for k, v in b.items()}
                  for b in (batch0, batch1))
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss0, _ = model.loss(tree_unflatten(params, req), batch)
    g = torch.autograd.grad(loss0, req)
    del req
    new_p, new_opt, om = adamw_update(params, tree_unflatten(params, list(g)), state0["opt"],
                                      opt)
    del new_opt
    lr0 = float(om["lr"])
    u = [(n - p).div_(lr0) for n, p in zip(tree_leaves(new_p), leaves)]
    del new_p
    gu = {"all": sum(float(torch.dot(a.flatten(), b.flatten())) for a, b in zip(g, u)),
          "head": sum(float(torch.dot(a.flatten(), b.flatten()))
                      for a, b, h in zip(g, u, is_head) if h)}
    gu["rest"] = gu["all"] - gu["head"]
    del g
    head_u = u[is_head.index(True)]
    moved = float((head_u.abs() >= 0.5).to(torch.float32).mean())
    seen = int(torch.unique(batch["labels"]).numel())

    @torch.no_grad()
    def loss_at(t: float, part: str, on=None) -> float:
        shifted = [p + t * d if (part == "all" or h == (part == "head")) else p
                   for p, d, h in zip(leaves, u, is_head)]
        return float(model.loss(tree_unflatten(params, shifted), batch if on is None else on)[0])

    base = float(loss0.detach())
    eps = 1e-2 / abs(gu["all"])
    slope = (loss_at(eps, "all") - loss_at(-eps, "all")) / (2 * eps)
    fd_rel = abs(slope - gu["all"]) / abs(gu["all"])
    line = {part: [loss_at(t, part) for t in LR_LINE] for part in ("all", "head", "rest")}
    line_next = {part: [loss_at(t, part, nxt) for t in LR_LINE]
                 for part in ("all", "head", "rest")}
    next_base = loss_at(0.0, "all", nxt)
    del u, head_u
    out = {"lr_first_step": lr0, "t": list(LR_LINE), "loss_at_0": base, "loss": line,
           "next_batch_loss_at_0": next_base, "next_batch_loss": line_next,
           "first_order": {part: [base + t * gu[part] for t in LR_LINE] for part in gu},
           "g_dot_u": gu, "fd_eps": eps, "fd_slope": slope, "fd_rel_err": fd_rel,
           "fd_tol": FD_TOL, "head_entries_moved_half_lr": moved,
           "vocab_ids_in_batch_labels": seen, "vocab": cfg.vocab, "activations": "float32"}
    check(fd_rel <= FD_TOL, f"train glm4-9b: the gradient along Adam's update is off the "
                            f"loss's central difference by {fd_rel} (allowed {FD_TOL})")
    return out


def phase_train_glm(torch, args, results: dict, smi: str) -> None:
    """glm4-9b at full width, depth cut to TRAIN_GLM_LAYERS: bf16
    activations, fp32 params and moments, batch 8 of 512 tokens in 4
    microbatches.  From one seeded state: the plain step, the FRC (s = 1)
    step under an all-ones and a one-straggler mask (loss and gradient,
    read by ``step.gradients``, against the plain step's), and under an
    undecodable mask (a whole group dead:
    params and optimizer state bit-equal).  Then 10 plain steps and 10 FRC
    steps under a rotating straggler, timed; one FRC step profiled; the
    loss must go down."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    full = get_config("glm4-9b")
    cfg = full.scaled(n_layers=TRAIN_GLM_LAYERS)
    emit({"phase": "cut", "path": "train glm4-9b", "n_layers": cfg.n_layers,
          "of": full.n_layers, "why": "params, gradients, fp32 moments and 4 fp32 coded "
                                      "messages of all 40 layers (9.4 G params) need about "
                                      "300 GB; the widths are full"})
    model = build_model(cfg)
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 1, 2 * TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    state0 = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed), opt,
                              device=dev)
    plain = make_train_step(model, opt, TrainConfig(microbatches=TRAIN_MICRO))
    coded = make_train_step(model, opt, TrainConfig(microbatches=TRAIN_MICRO,
                                                    gradient_coding="frc", gc_stragglers=1))
    pipe = make_pipeline(cfg, seq=TRAIN_GLM_SEQ, global_batch=TRAIN_BATCH, seed=args.seed)
    n_params = sum(p.numel() for p in tree_leaves(state0["params"]))
    memory = _train_memory(state0["params"], TRAIN_MICRO, compress=False)
    emit({"phase": "init", "path": "train glm4-9b", "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params,
          "memory_reckoned": memory})

    batch0 = pipe.batch(0)
    checks = _coded_step_checks(torch, "train glm4-9b FRC", plain, coded, state0, batch0,
                                ([1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0]),
                                [0.0, 0.0, 1.0, 1.0])
    check_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    lr_line = _lr_line(torch, cfg, state0, batch0, pipe.batch(1), opt)
    emit({"phase": "lr line", "path": "train glm4-9b", **lr_line, "card": smi})
    torch.cuda.empty_cache()

    runs = {}
    box = {"state": state0}
    del state0
    for name, step, mask_fn in (
            ("plain", plain, lambda i: None),
            ("frc", coded, lambda i: torch.tensor([0.0 if w == i % TRAIN_MICRO else 1.0
                                                   for w in range(TRAIN_MICRO)], device=dev))):
        torch.cuda.reset_peak_memory_stats()
        first = 1 + (TRAIN_STEPS if name == "frc" else 0)
        ms, losses = _timed_train(torch, step, box, pipe, first, TRAIN_STEPS, mask_fn)
        med = float(np.median(ms[1:]))
        runs[name] = {"step_ms": ms, "median_step_ms": med,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_GLM_SEQ / med * 1e3,
                      "losses": losses, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"train glm4-9b {name}: {med:.1f} ms a step, "
              f"{runs[name]['tokens_per_s']:.0f} tokens/s, peak {runs[name]['peak_gb']:.1f} GB",
              flush=True)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0], device=dev)
    prof = _profile_one(torch, lambda: coded(box["state"], pipe.batch(99), mask))
    prof["device_ms_over_step_ms"] = prof["device_ms"] / runs["frc"]["median_step_ms"]
    losses = runs["plain"]["losses"] + runs["frc"]["losses"]
    row = {"phase": "train", "path": "train glm4-9b", "arch": cfg.name, "n_layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_GLM_SEQ, "microbatches": TRAIN_MICRO,
           "activations": cfg.dtype, "params": n_params, "memory_reckoned": memory,
           "checks_peak_gb": check_peak, "checks": checks, "lr_line": lr_line, "runs": runs,
           "profile_frc": prof, "card": smi}
    emit(row)
    results["train glm4-9b"] = row
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"train glm4-9b: the loss did not go down over 20 steps: {losses}")
    del box
    gc.collect()
    torch.cuda.empty_cache()


def _ssd_call_inputs(torch, cfg, params, tokens) -> tuple:
    """The (x, da, b, c, chunk) block 0's SSD gets in a train forward of
    ``tokens``: the embedding, the block's norm, then its projection, conv
    and split (``models.ssm.ssd_prefill_inputs``, as ``mamba_block_apply``
    makes them)."""
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.ssm import ssd_prefill_inputs
    from repro_torch.utils.tree import tree_map

    blocks = params["blocks"]
    gp = blocks[0] if isinstance(blocks, list) else tree_map(lambda t: t[0], blocks)
    with torch.no_grad():
        x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
        return (*ssd_prefill_inputs(gp["mamba"], cfg, rmsnorm(x, gp["ln1"], cfg.norm_eps)),
                cfg.ssm_chunk)


def _ssd_cells_of(torch, x, da, b, c, chunk: int) -> tuple:
    """ssd_forward's cells of a block's SSD inputs: x [G, Q, P], da [G, Q],
    b, c [G, Q, N] (heads expanded), as ops.ssd_forward builds them."""
    bsz, s, h, p = x.shape
    n, q = b.shape[3], min(chunk, s)
    nc, rep = s // q, h // b.shape[2]

    def cells(t, feat):
        t = t.reshape(bsz, nc, q, h, feat).permute(0, 3, 1, 2, 4)
        return t.reshape(bsz * h * nc, q, feat).contiguous()

    dac = da.to(torch.float32).reshape(bsz, nc, q, h).permute(0, 3, 1, 2)
    return (cells(x, p), dac.reshape(bsz * h * nc, q).contiguous(),
            cells(torch.repeat_interleave(b, rep, dim=2), n),
            cells(torch.repeat_interleave(c, rep, dim=2), n))


def _train_ssd_checks(torch, cfg, params, tokens, label: str, results: dict) -> dict:
    """At one block's real SSD inputs of a train forward: ssd_chunk and
    ssd_combine against their plain versions (and timed, as the kernel
    phase times them), and SSDScan's gradients against autograd through
    ssd_chunked; the time of SSDScan's backward (the ssd_chunked
    recompute)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device("cuda")
    x, da, b, c, chunk = _ssd_call_inputs(torch, cfg, params, tokens)
    xc, dac, bc, cc = _ssd_cells_of(torch, x, da, b, c, chunk)
    g, q, p = xc.shape
    n = bc.shape[2]
    got, want = ssd_chunk_cuda(xc, dac, bc, cc), ref.ref_ssd_chunk(xc, dac, bc, cc)
    gen = torch.Generator(device=dev).manual_seed(19)
    s_in = 0.1 * torch.randn(g, p, n, device=dev, generator=gen)
    y_off, y_off_want = ssd_combine_cuda(cc, want[3], s_in), ref.ref_ssd_combine(cc, want[3], s_in)
    torch.cuda.synchronize()
    checks = dict(zip(("y_diag", "states", "decay", "cum"),
                      (_ssd_check(torch, gv, wv) for gv, wv in zip(got, want))))
    comb = _ssd_check(torch, y_off, y_off_want)
    dname = str(xc.dtype).removeprefix("torch.")
    row_c = {"phase": "kernel", "kernel": "ssd_chunk", "shape": label, "g": g, "q": q, "p": p,
             "n": n, "dtype": dname, "da_draw": "a train forward's block 0",
             "errors": {k: v[0] for k, v in checks.items()},
             "tols": {k: v[1] for k, v in checks.items()},
             "max_abs_err": checks["y_diag"][0], "tol": checks["y_diag"][1]}
    row_m = {"phase": "kernel", "kernel": "ssd_combine", "shape": label, "g": g, "q": q, "p": p,
             "n": n, "dtype": dname, "da_draw": "a train forward's block 0",
             "max_abs_err": comb[0], "tol": comb[1]}
    _ssd_timed(torch, row_c, row_m, xc, dac, bc, cc, want[3], s_in)
    emit(row_c)
    emit(row_m)
    for k, (err, tol, ok) in checks.items():
        check(ok, f"ssd_chunk {label} {k}: max err {err}, allowed {tol}")
    check(comb[2], f"ssd_combine {label}: max err {comb[0]}, allowed {comb[1]}")
    results.setdefault("ssd_chunk", {})[label] = row_c
    results.setdefault("ssd_combine", {})[label] = row_m
    del xc, dac, bc, cc, got, want, s_in, y_off, y_off_want

    # SSDScan: forward = the kernels', gradients = ssd_chunked's
    ins = [t.detach().clone().requires_grad_(True) for t in (x, da, b, c)]
    y, fin = ops.SSDScan.apply(*ins, chunk, None)
    with torch.no_grad():
        wy, wfin = ops.ssd_forward(x, da, b, c, chunk, mode="cuda")
    gy = torch.randn(y.shape, device=dev, generator=gen).to(y.dtype)
    gots = torch.autograd.grad(y, ins, gy)
    ref_in = [t.detach().clone().requires_grad_(True) for t in (x, da, b, c)]
    wants = torch.autograd.grad(ssd_chunked(*ref_in, chunk)[0], ref_in, gy)
    grad_err = max(float((a.float() - w.float()).abs().max()) / max(float(w.float().abs().max()),
                                                                     1.0)
                   for a, w in zip(gots, wants))
    fwd_equal = bool(torch.equal(y, wy) and torch.equal(fin, wfin))

    def recompute():
        inp = [t.detach().requires_grad_(True) for t in (x, da, b, c)]
        torch.autograd.grad(ssd_chunked(*inp, chunk)[0], inp, gy)

    recompute_ms = time_ms(torch, recompute, 5)
    out = {"inputs": [list(t.shape) for t in (x, da, b, c)], "dtype": dname,
           "forward_bit_equal": fwd_equal, "grad_rel_err": grad_err, "grad_tol": 1e-5,
           "recompute_ms": recompute_ms}
    check(fwd_equal, f"{label}: SSDScan's forward differs from ssd_forward on the kernels")
    check(grad_err <= 1e-5, f"{label}: SSDScan's gradients off ssd_chunked's by {grad_err}")
    return out


def _refusals(torch) -> dict:
    """Each kernel wrapper called under grad mode with an input that
    requires grad: it must raise, naming itself, and launch nothing."""
    from repro_torch.kernels import kernel_wrappers

    dev = torch.device("cuda")
    x = torch.ones(4, 4, device=dev, requires_grad=True)
    one = torch.ones(4, 4, device=dev)
    n_args = {"coded_matvec": 2, "coded_matvec_decode": 3, "gaussian_encode": 2,
              "lt_encode": 3, "masked_pinv": 2, "prefill_attn": 7, "ssd_chunk": 4,
              "ssd_combine": 3}
    out = {}
    for name, wrapper in kernel_wrappers().items():
        before = wrapper.launches
        try:
            wrapper(x, *[one] * (n_args[name] - 1))
            out[name] = "launched"
        except RuntimeError as e:
            out[name] = "raised" if wrapper.__name__ in str(e) else f"raised: {e}"
        check(out[name] == "raised" and wrapper.launches == before,
              f"{name}'s wrapper took an input that requires grad: {out[name]}")
    return out


def phase_train_zamba(torch, args, results: dict, smi: str) -> None:
    """zamba2-1.2b at full width, TRAIN_ZAMBA_LAYERS of its 38 layers (the
    cut printed): batch 8 of 1024 tokens (4 SSD chunks a block) in 4
    microbatches.  First, from one seeded
    state: the cyclic (s = 1) step against the plain step under an
    all-ones and a one-straggler mask, and under two stragglers
    (undecodable: the state bit-equal).  Then the train launcher
    (``repro_torch.launch.train.main``): a short run with ``--adaptive-s``
    (the controller's levels), and the timed run at a fixed s = 1 with
    int8 message compression and error feedback under Markov stragglers at
    the paper's 0.2 and 3x (each step decodes around the slowest worker).
    The timed run's SSD launches must be one of each kernel per Mamba block
    per forward and per checkpoint recompute.  Then, at block 0's real
    inputs of a microbatch: the kernels against their plain versions
    (timed), SSDScan against ssd_chunked's autograd, and the time of its
    recompute; the wrappers' refusals; one step of the timed configuration
    profiled."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step

    dev = torch.device("cuda")
    full = get_config("zamba2-1.2b")
    cfg = full.scaled(n_layers=TRAIN_ZAMBA_LAYERS)
    emit({"phase": "cut", "path": "train zamba2-1.2b", "n_layers": cfg.n_layers,
          "of": full.n_layers, "why": "the script's 1,200 s limit; the hybrid serve runs all "
                                      "38 layers; the widths are full"})
    model = build_model(cfg)
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 1, TRAIN_ZAMBA_STEPS))
    pipe = make_pipeline(cfg, seq=TRAIN_ZAMBA_SEQ, global_batch=TRAIN_BATCH, seed=args.seed)
    batch = pipe.batch(0)
    state0 = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed), opt,
                              device=dev)
    checks = _coded_step_checks(
        torch, "train zamba2-1.2b cyclic", make_train_step(model, opt, TrainConfig(
            microbatches=TRAIN_MICRO)),
        make_train_step(model, opt, TrainConfig(microbatches=TRAIN_MICRO,
                                                gradient_coding="cyclic", gc_stragglers=1)),
        state0, batch, ([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]), [0.0, 1.0, 0.0, 1.0])
    del state0
    gc.collect()
    torch.cuda.empty_cache()

    base = ["--arch", "zamba2-1.2b", "--layers", str(TRAIN_ZAMBA_LAYERS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_ZAMBA_SEQ),
            "--microbatches", str(TRAIN_MICRO), "--lr", str(TRAIN_LR),
            "--gradient-coding", "cyclic", "--gc-stragglers", "1", "--compress", "int8",
            "--straggler-prob", "0.2", "--straggler-slowdown", "3", "--log-every", "1",
            "--seed", str(args.seed)]
    rec = train.main(base + ["--steps", str(TRAIN_ADAPTIVE_STEPS), "--adaptive-s"])
    adaptive = {"levels": [lvl for _, _, _, lvl, _ in rec["steps"]],
                "ok": [ok for _, _, ok, _, _ in rec["steps"]],
                "losses": [loss for _, loss, _, _, _ in rec["steps"]]}
    check(len(adaptive["levels"]) == TRAIN_ADAPTIVE_STEPS
          and set(adaptive["levels"]) <= {0, 1} and all(np.isfinite(adaptive["losses"])),
          f"train zamba2-1.2b --adaptive-s: {adaptive}")
    del rec
    gc.collect()
    torch.cuda.empty_cache()

    argv = base + ["--steps", str(TRAIN_ZAMBA_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    rec = train.main(argv)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = rec["state"]
    steps = rec["steps"]
    want = cfg.n_layers * TRAIN_MICRO * 2 * len(steps)   # forward + recompute, every microbatch
    check(launches["ssd_chunk"] == want and launches["ssd_combine"] == want,
          f"train zamba2-1.2b: SSD launches {launches}, want {want} of each "
          f"({cfg.n_layers} blocks x {TRAIN_MICRO} microbatches x 2 x {len(steps)} steps)")
    losses = [loss for _, loss, _, _, _ in steps]
    levels = [lvl for _, _, _, lvl, _ in steps]
    oks = [ok for _, _, ok, _, _ in steps]
    check(all(np.isfinite(losses)), f"train zamba2-1.2b: losses {losses}")
    check(levels == [1] * len(steps) and oks == [1.0] * len(steps),
          f"train zamba2-1.2b: levels {levels}, ok {oks}: every step must decode at s = 1")
    ms = [sec * 1e3 for _, _, _, _, sec in steps]
    med = float(np.median(ms[1:]))
    tokens = torch.as_tensor(batch["tokens"][:TRAIN_BATCH // TRAIN_MICRO], device="cuda").long()
    ssd = _train_ssd_checks(torch, cfg, state["params"], tokens,
                            f"zamba2-1.2b train {TRAIN_BATCH // TRAIN_MICRO}x{TRAIN_ZAMBA_SEQ} "
                            f"bfloat16", results)
    ssd["recompute_share_of_step"] = ssd["recompute_ms"] * cfg.n_layers * TRAIN_MICRO / med
    refusals = _refusals(torch)
    step = make_train_step(model, opt, TrainConfig(
        microbatches=TRAIN_MICRO, gradient_coding="cyclic", gc_stragglers=1, compression="int8"))
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda")
    prof = _profile_one(torch, lambda: step(state, batch, mask))
    prof["device_ms_over_step_ms"] = prof["device_ms"] / med
    row = {"phase": "train", "path": "train zamba2-1.2b", "arch": cfg.name,
           "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_ZAMBA_SEQ,
           "microbatches": TRAIN_MICRO, "checks": checks, "adaptive": adaptive, "argv": argv,
           "launches": launches,
           "memory_reckoned": _train_memory(state["params"], TRAIN_MICRO, compress=True),
           "peak_gb": peak, "step_ms": ms, "median_step_ms": med,
           "tokens_per_s": TRAIN_BATCH * TRAIN_ZAMBA_SEQ / med * 1e3, "losses": losses,
           "levels": levels, "ok": oks, "skipped": rec["skipped"], "ssd_scan": ssd,
           "refusals": refusals, "profile": prof, "card": smi}
    emit(row)
    results["train zamba2-1.2b"] = row
    del rec, state, step
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_drill(torch, args, results: dict, smi: str) -> None:
    """The death drill: mamba2-130m (full width and depth) through the
    train launcher on a grid of 8 logical devices (TP 4, so 2 DP slices),
    FRC at s = 0 over 4 microbatches of 2 x 512 tokens, 10 steps, a
    checkpoint every 3 steps under a temporary directory, the last DP slice
    killed at step 7.  Its workers' steps cannot decode: 2 skipped steps,
    the grid shrinks 2 -> 1 DP slices, the run resumes from step 6.  The losses
    after the restore must equal, bit for bit, those of a run started fresh
    from a copy of that checkpoint: both run under
    ``torch.use_deterministic_algorithms`` (the embedding and gather
    backwards add without atomics)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    cfg = get_config("mamba2-130m")
    base = ["--arch", "mamba2-130m", "--steps", "10", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_DRILL_SEQ), "--microbatches", str(TRAIN_MICRO),
            "--gradient-coding", "frc", "--gc-stragglers", "0", "--log-every", "4",
            "--seed", str(args.seed)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            _reset_launches()
            t0 = time.perf_counter()
            rec = train.main(base + ["--logical-devices", "8", "--mesh-model", "4",
                                     "--ckpt-dir", ck, "--ckpt-every", "3", "--kill-at", "7",
                                     "--detect-steps", "2"])
            wall = time.perf_counter() - t0
            launches = _launches()
            fresh = os.path.join(tmp, "fresh")
            os.makedirs(fresh)
            shutil.copytree(os.path.join(ck, "step_00000006"),
                            os.path.join(fresh, "step_00000006"))
            rec2 = train.main(base + ["--ckpt-dir", fresh, "--ckpt-every", "100"])
    finally:
        torch.use_deterministic_algorithms(False)
    batch = make_pipeline(cfg, seq=TRAIN_DRILL_SEQ, global_batch=TRAIN_BATCH,
                          seed=args.seed).batch(0)
    tokens = torch.as_tensor(batch["tokens"][:TRAIN_BATCH // TRAIN_MICRO], device="cuda").long()
    ssd = _train_ssd_checks(torch, cfg, rec["state"]["params"], tokens,
                            f"mamba2-130m train {TRAIN_BATCH // TRAIN_MICRO}x{TRAIN_DRILL_SEQ} "
                            f"bfloat16", results)
    steps = rec["steps"]
    ok_first = [ok for _, _, ok, _, _ in steps[:9]]
    after = [(s, loss) for s, loss, _, _, _ in steps[9:]]
    fresh_after = [(s, loss) for s, loss, _, _, _ in rec2["steps"]]
    diffs = [abs(a[1] - b[1]) for a, b in zip(after, fresh_after)]
    want = cfg.n_layers * TRAIN_MICRO * 2 * len(steps)
    row = {"phase": "train", "path": "train drill", "arch": "mamba2-130m",
           "batch": TRAIN_BATCH, "seq": TRAIN_DRILL_SEQ, "microbatches": TRAIN_MICRO,
           "events": rec["events"], "skipped": rec["skipped"], "grid_after": rec["mesh"],
           "ok_first_9": ok_first, "losses_after_restore": after,
           "median_step_ms": float(np.median([sec * 1e3 for _, _, _, _, sec in steps[1:]])),
           "losses_fresh_from_checkpoint": fresh_after, "max_loss_diff": max(diffs),
           "launches": launches, "wall_s": wall, "ssd_scan": ssd, "card": smi}
    emit(row)
    results["train drill"] = row
    check(rec["events"] == [{"at": 9, "dp_before": 2, "dp_after": 1, "restored_step": 6}],
          f"train drill: elastic events {rec['events']}")
    check(rec["skipped"] == 2 and ok_first == [1.0] * 7 + [0.0, 0.0],
          f"train drill: ok over the first 9 steps {ok_first}")
    check(rec["mesh"] == {"data": 1, "model": 4}, f"train drill: grid after {rec['mesh']}")
    check([s for s, _ in after] == list(range(7, 11)) and after == fresh_after,
          f"train drill: losses after the restore {after} differ from a fresh run from the "
          f"checkpoint {fresh_after}")
    check(launches["ssd_chunk"] == want and launches["ssd_combine"] == want,
          f"train drill: SSD launches {launches}, want {want} of each")
    del rec, rec2
    gc.collect()
    torch.cuda.empty_cache()


# the moe, vlm and encdec train phases: arch -> (depth, or None for the whole
# model; batch; seq; microbatches; the coded step's scheme, or None)
FAMILY_TRAIN = {
    "llama-3.2-vision-11b": (5, 8, 512, 4, "frc"),
    "dbrx-132b": (1, 8, 512, 1, None),
    "seamless-m4t-large-v2": (12, 8, 512, 4, "frc"),
}
FAMILY_TRAIN_WHY = {
    "llama-3.2-vision-11b": "one group of 5 of the 40 layers (four self-attention layers and "
                            "the gated cross-attention layer): fp32 params and gradients, int8 "
                            "moments and 4 fp32 coded messages of all 40 (10.1 G params) need "
                            "about 260 GB; the widths are full",
    "dbrx-132b": "one of the 40 layers: its 16 experts are 3.17 G params, 12.7 GB in fp32; "
                 "params, gradients and int8 moments of all 40 (132 G params) need about "
                 "1.3 TB; one microbatch (no accumulator) and no coded step (4 fp32 messages "
                 "would be 72 GB); the widths are full",
    "seamless-m4t-large-v2": "12 of the 24 encoder and 12 of the 24 decoder layers, for the "
                             "script's 1,200 s limit (the encdec serve runs all 48); the "
                             "widths are full",
}
FAMILY_TRAIN_STEPS = 4        # timed steps of each run (plain, then coded); the first not in the median
# the timed steps cycle over this many batches: on fresh batches of the
# pipeline's Markov chain over a 100k-256k vocabulary the loss shows no fall
# at TRAIN_LR within 10 steps (PERF.md, Findings); a batch seen again does
FAMILY_TRAIN_BATCHES = 2
FAMILY_TRAIN_MOMENTS = "int8"  # fp32 moments and 4 fp32 messages do not fit beside the vlm's 2.2 G params


def _watched(cfg, path: str) -> bool:
    """The gradient leaves a family's phase holds to be non-zero: the vlm's
    gated cross-attention (gate and weights), the MoE router, the encdec's
    cross-attention and the encoder's first weights (reached only through
    the cross-attention)."""
    if cfg.family == "vlm":
        return path.startswith("blocks/xattn_")
    if cfg.family == "moe":
        return path.endswith("/router")
    return path.startswith("dec_blocks/xattn/") or path == "enc_blocks/attn/w_q"


def phase_train_family(torch, args, results: dict, smi: str, arch: str) -> None:
    """A train phase of the moe, vlm or encdec family (``FAMILY_TRAIN``):
    full width, int8 moments, the depth cut printed on a cut line.  From
    one seeded state (vlm: every cross-attention gate at ``GATE``, so the
    cross path carries gradient): the plain step's gradient, whose watched
    leaves (``_watched``) must be non-zero and finite, with the loss, the
    aux loss and, for the moe, the share of (token, k) assignments dropped
    at capacity; where a coded step runs, ``_coded_step_checks`` against
    the plain step.  Then ``FAMILY_TRAIN_STEPS`` plain and as many coded
    steps (a rotating straggler), timed (step ms, tokens/s, peak GB) on
    ``FAMILY_TRAIN_BATCHES`` batches made beforehand, taken in turn, and
    one step profiled (device busy share).  The loss must go down over the
    timed steps, and none of the six kernels may launch."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import transformer
    from repro_torch.models.moe import route
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    from repro_torch.utils.tree import tree_flatten_with_path, tree_leaves

    dev = torch.device("cuda")
    layers, batch_n, seq, micro, scheme = FAMILY_TRAIN[arch]
    full = get_config(arch)
    cfg = full.scaled(n_layers=layers, **({"enc_layers": layers} if full.family == "encdec"
                                          else {}))
    path = f"train {arch}"
    cut = {"phase": "cut", "path": path, "n_layers": cfg.n_layers, "of": full.n_layers,
           "why": FAMILY_TRAIN_WHY[arch]}
    if cfg.family == "encdec":
        cut.update(enc_layers=cfg.enc_layers, enc_of=full.enc_layers)
    emit(cut)
    model = build_model(cfg)
    runs_spec = [("plain", TrainConfig(microbatches=micro))]
    if scheme is not None:
        runs_spec.append((scheme, TrainConfig(microbatches=micro, gradient_coding=scheme,
                                              gc_stragglers=1)))
    n_steps = len(runs_spec) * FAMILY_TRAIN_STEPS
    opt = AdamWConfig(lr=warmup_cosine(TRAIN_LR, 1, n_steps), moment_dtype=FAMILY_TRAIN_MOMENTS)
    steps = {name: make_train_step(model, opt, tc) for name, tc in runs_spec}
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state0 = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed), opt,
                              device=dev)
    if cfg.family == "vlm":
        for name, sub in state0["params"]["blocks"].items():
            if name.startswith("xattn_"):
                sub["gate"].fill_(GATE)
    n_params = sum(p.numel() for p in tree_leaves(state0["params"]))
    memory = _train_memory(state0["params"], micro, compress=False, coded=scheme is not None,
                           moment_dtype=FAMILY_TRAIN_MOMENTS)
    emit({"phase": "init", "path": path, "family": cfg.family, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params,
          "batch": batch_n, "seq": seq, "microbatches": micro, "memory_reckoned": memory})
    pipe = make_pipeline(cfg, seq=seq, global_batch=batch_n, seed=args.seed)
    t0 = time.perf_counter()
    batches = [pipe.batch(i) for i in range(FAMILY_TRAIN_BATCHES)]   # before any step is timed
    batches_s = time.perf_counter() - t0
    data = types.SimpleNamespace(batch=lambda i: batches[i % FAMILY_TRAIN_BATCHES])

    # the plain step's gradient at the seeded state, each MoE call's routing recorded
    drops, real_moe = [], transformer.moe_apply

    def moe(p, x, **kw):
        with torch.no_grad():
            r = route(p, x.reshape(-1, x.shape[-1]), top_k=kw["top_k"],
                      capacity_factor=kw["capacity_factor"],
                      dispatch_groups=kw["dispatch_groups"])
            drops.append((int((~r.keep).sum()), r.keep.numel(), r.cap))
        return real_moe(p, x, **kw)

    transformer.moe_apply = moe
    try:
        loss, met, grads, _, _ = steps["plain"].gradients(state0, batches[0])
    finally:
        transformer.moe_apply = real_moe
    paths = [p for p, _ in tree_flatten_with_path(state0["params"])]
    if cfg.family == "moe":
        # is the MoE backward (the gather of each slot's row, the scatter's
        # index_add_) deterministic on the card? each leaf's bits summed as
        # int32, against a second pass from the same state; reported, not
        # held: no phase claims bit-equal MoE gradients
        def bits(gs):
            return [int(torch.sum(g.view(torch.int32), dtype=torch.int64)) for g in gs]

        sig = bits(grads)
        again = steps["plain"].gradients(state0, batches[0])[2]
        rerun_equal = sig == bits(again)
        del again
    watched = {p: {"max_abs_grad": float(g.abs().max()), "finite": bool(torch.isfinite(g).all())}
               for p, g in zip(paths, grads) if _watched(cfg, p)}
    first = {"loss": float(loss), "ce": float(met["ce"]), "aux": float(met["aux"]),
             "finite_grads": all(bool(torch.isfinite(g).all()) for g in grads),
             "watched_grads": watched}
    if drops:
        first["gradient_bits_equal_on_a_rerun"] = rerun_equal
        first["moe_calls"] = len(drops)   # forward and remat recompute, each MoE layer
        first["dropped_share"] = sum(d for d, _, _ in drops) / sum(n for _, n, _ in drops)
        first["assignments_and_cap"] = sorted({(n, c) for _, n, c in drops})
    del grads
    torch.cuda.empty_cache()
    check(first["finite_grads"] and np.isfinite(first["loss"]),
          f"{path}: the first gradient or loss is not finite ({first['loss']})")
    check(watched and all(w["finite"] and w["max_abs_grad"] > 0 for w in watched.values()),
          f"{path}: a watched gradient is zero or not finite: {watched}")
    checks = None
    if scheme is not None:
        checks = _coded_step_checks(torch, f"{path} {scheme}", steps["plain"], steps[scheme],
                                    state0, batches[0],
                                    ([1.0] * micro, [1.0, 0.0] + [1.0] * (micro - 2)),
                                    [0.0, 0.0] + [1.0] * (micro - 2))
    check_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    runs = {}
    box = {"state": state0}
    del state0
    for i, (name, _) in enumerate(runs_spec):
        def mask_fn(j, coded=name != "plain"):
            if not coded:
                return None
            return torch.tensor([0.0 if w == j % micro else 1.0 for w in range(micro)],
                                device=dev)

        torch.cuda.reset_peak_memory_stats()
        ms, losses = _timed_train(torch, steps[name], box, data, 1 + i * FAMILY_TRAIN_STEPS,
                                  FAMILY_TRAIN_STEPS, mask_fn)
        med = float(np.median(ms[1:]))
        runs[name] = {"step_ms": ms, "median_step_ms": med,
                      "tokens_per_s": batch_n * seq / med * 1e3, "losses": losses,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"{path} {name}: {med:.1f} ms a step, {runs[name]['tokens_per_s']:.0f} tokens/s, "
              f"peak {runs[name]['peak_gb']:.1f} GB", flush=True)
    last = runs_spec[-1][0]
    mask = mask_fn(n_steps + 1)
    prof = _profile_one(torch, lambda: steps[last](box["state"], data.batch(n_steps + 1),
                                                   *(() if mask is None else (mask,))))
    prof["device_ms_over_step_ms"] = prof["device_ms"] / runs[last]["median_step_ms"]
    prof["step"] = last
    launches = _launches()
    losses = [x for r in runs.values() for x in r["losses"]]
    row = {"phase": "train", "path": path, "arch": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "batch": batch_n, "seq": seq, "microbatches": micro,
           "activations": cfg.dtype, "moments": FAMILY_TRAIN_MOMENTS, "params": n_params,
           "memory_reckoned": memory, "checks_peak_gb": check_peak, "first_step": first,
           "checks": checks, "runs": runs, "profile": prof, "launches": launches,
           "batches": FAMILY_TRAIN_BATCHES, "batches_made_s": batches_s, "card": smi}
    if cfg.family == "vlm":
        row["gate"] = GATE
    emit(row)
    results[path] = row
    check(not any(launches.values()), f"{path}: a kernel launched on a train path that runs "
                                      f"none: {launches}")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]),
          f"{path}: the loss did not go down over the timed steps: {losses}")
    del box, batches, data
    gc.collect()
    torch.cuda.empty_cache()


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
# the slab engine at the EC2 example's tables: kLaneCols (a copy built for
# each) and the span width
LT_SLAB_SWEEP = [(lane_cols, width) for lane_cols in (1, 2, 4) for width in (16, 32, 64)]


def _lt_variants(settings: list[dict]) -> dict:
    """lt_encode.cu rebuilt with other constants (each setting a {name:
    value} of constexpr ints: kSpanQuads, kRowsPerChunk, kLaneCols), one
    nvcc each, started together, under build/lt_sweep; {the setting's
    values: the loaded library}."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "lt_encode.cu").read_text()
    out_dir = _build.BUILD_DIR.parent / "lt_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for setting in settings:
        text = src
        for name, value in setting.items():
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            check(n == 1, f"lt_encode.cu defines {name} {n} times, not once")
        key = tuple(setting.values())
        cu = out_dir / ("lt_encode_" + "_".join(f"{k}{v}" for k, v in setting.items()) + ".cu")
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc of the lt_encode variant {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _lt_table(which: str, seed: int):
    """(r, m, indices, coeffs) of the LT table the task path hands lt_encode:
    'whole plan', all of Â at scenario 1 (a run at m = 8 on the CPU: the
    task runs in model time, so the table does not depend on m), or 'ec2'
    ('ec2 first'), the EC2 example's last (first) coded task (``--scale 40
    --trials 2`` with the CPU encode: the tables do not depend on where Â
    is encoded)."""
    if which == "whole plan":
        from repro_torch.kernels import autotune

        r, plan = autotune.lt_task_table(seed, reserve=False)
        return r, PAPER_M, plan.indices, plan.coeffs
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(
        "ec2_repro_torch", os.path.join(HERE, "examples", "ec2_repro_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()):
        records = example.main([*EC2_ARGS, "--device", "cpu"])
    rec = [rec for rec in records if rec["scheme"] in ("hcmm", "bpcc")][
        0 if which == "ec2 first" else -1]
    (r, m), plan = rec["a_shape"], rec["encode"]["plan"]
    return r, m, plan.indices, plan.coeffs


def _lt_l2_breakdown(torch, a, csr, iters: int) -> dict:
    """Where the shipped L2 engine's time goes on a table (device time,
    ``device_ms``): the whole launch; a launch whose unit counter is already
    spent (the launch, the persistent grid's start and one atomic: the
    floor); the heavy units alone (order cut to the heavy rows) and the
    light ones alone; the CSR with no row marked heavy; and the host time
    of a call through the wrapper and through the bare C entry."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.lt_encode import _lt_launch

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.c_function("lt_encode", "lt_encode",
                           [p, p, p, p, p, p, i, ctypes.c_longlong, i, p, p])
    q, m = csr.order.numel(), a.shape[1]
    out = torch.empty(q, m, device=a.device)
    counter = torch.zeros(1, dtype=torch.int64, device=a.device)
    spent = torch.full((1,), 1 << 60, dtype=torch.int64, device=a.device)

    def launch(order=csr.order, rows=q, n_heavy=csr.n_heavy, ctr=counter, zero=True):
        if zero:
            ctr.zero_()
        err = fn(a.data_ptr(), csr.row_ptr.data_ptr(), csr.cols.data_ptr(), csr.vals.data_ptr(),
                 order.data_ptr(), out.data_ptr(), rows, m, n_heavy, ctr.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"lt_encode breakdown: cudaError {err}")

    light = csr.order[csr.n_heavy:].contiguous()
    row = {"kernel_ms": device_ms(torch, launch, iters),
           "spent_counter_ms": device_ms(torch, lambda: launch(ctr=spent, zero=False), iters),
           "no_heavy_split_ms": device_ms(torch, lambda: launch(n_heavy=0), iters),
           "light_units_alone_ms": device_ms(torch, lambda: launch(light, q - csr.n_heavy, 0),
                                             iters),
           "host_ms_wrapper": host_ms(torch, lambda: _lt_launch(a, csr, engine="l2"), 50),
           "host_ms_direct": host_ms(torch, launch, 50)}
    if csr.n_heavy:
        row["heavy_units_alone_ms"] = device_ms(
            torch, lambda: launch(rows=csr.n_heavy), iters)
    return row


def sweep_lt(torch, args, smi: str) -> None:
    """lt_encode's two engines at the task path's two table shapes, each
    setting a variant of lt_encode.cu built here, held to the plain
    version's bits and timed (device time) in turns with torch.sparse.mm on
    the same CSR; one JSON line a shape.  At the whole LT plan (A [5,000,
    500,000], too large a table for a slab) the L2 engine for each span
    width (128 x 1, 2, 4, 8 columns), light rows per unit (8, 16, 32) and
    with and without the heavy-row split (a CSR that marks no row heavy);
    at the EC2 example's last and first coded tasks (A [500, 10,000] and
    [125, 10,000]) the slab engine for each kLaneCols (1, 2, 4) and span
    width (16, 32, 64) that fits, beside the shipped L2 engine; at each
    table where the shipped L2 engine's time goes (``_lt_l2_breakdown``)."""
    import ctypes

    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import (LT_SLAB_LANE_COLS, LT_SLAB_SMEM, _lt_csr,
                                               _sm_count, lt_slab_plan, lt_slab_smem)

    t0 = time.perf_counter()
    libs = _lt_variants(
        [{"kSpanQuads": quads, "kRowsPerChunk": rows}
         for quads, rows in sorted({(quads, rows) for quads, rows, _ in LT_SWEEP})]
        + [{"kLaneCols": lc} for lc in sorted({lc for lc, _ in LT_SLAB_SWEEP})])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p, i = ctypes.c_void_p, ctypes.c_int
    for which in ("whole plan", "ec2", "ec2 first"):
        r, m, idx, cof = _lt_table(which, args.seed)
        a = torch.randn(r, m, device=dev, generator=gen)
        i_t = torch.as_tensor(idx, device=dev)
        c_t = torch.as_tensor(cof, device=dev)
        q = i_t.shape[0]
        want = ref.ref_lt_encode(a, i_t, c_t)
        csr = _lt_csr(i_t, c_t, r)
        u, nnz = csr.n_used, csr.cols.numel()
        sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.cols.long(), csr.vals, size=(q, r),
                                         check_invariants=False)
        library = lambda: torch.sparse.mm(sparse, a)  # noqa: E731
        iters = 3 if which == "whole plan" else 20
        out = torch.empty(q, m, device=dev)
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        runs = []

        def timed(launch, entry: dict) -> None:
            out.zero_()
            launch()
            torch.cuda.synchronize()
            exact = torch.equal(out, want)
            turns = [device_ms(torch, fn, iters) for fn in (launch, library, library, launch)]
            entry.update(kernel_ms=(turns[0] + turns[3]) / 2, library_ms=(turns[1] + turns[2]) / 2,
                         turns_ms=turns, bit_equal=exact)
            entry["ratio"] = entry["kernel_ms"] / entry["library_ms"]
            runs.append(entry)
            check(exact, f"lt_encode {which} {entry}: not the plain version's bits")

        sweeps = LT_SWEEP if which == "whole plan" else [(1, 16, True)]
        for quads, rows, heavy in sweeps:
            fn = libs[(quads, rows)].lt_encode
            fn.argtypes = [p, p, p, p, p, p, i, ctypes.c_longlong, i, p, p]
            fn.restype = ctypes.c_int
            c = csr if heavy else csr._replace(n_heavy=0)

            def launch(fn=fn, c=c):
                counter.zero_()
                err = fn(a.data_ptr(), c.row_ptr.data_ptr(), c.cols.data_ptr(), c.vals.data_ptr(),
                         c.order.data_ptr(), out.data_ptr(), q, m, c.n_heavy, counter.data_ptr(),
                         stream())
                check(err == 0, f"lt_encode variant ({quads}, {rows}): cudaError {err}")

            timed(launch, {"engine": "l2", "span": 128 * quads, "rows_per_chunk": rows,
                           "heavy_split": heavy})
        if which != "whole plan":
            for lane_cols, width in LT_SLAB_SWEEP:
                smem = lt_slab_smem(q, u, nnz, width)
                if smem > LT_SLAB_SMEM:
                    continue
                fn = libs[(lane_cols,)].lt_encode_slab
                fn.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_longlong, i, p]
                fn.restype = ctypes.c_int

                def launch(fn=fn, width=width):
                    err = fn(a.data_ptr(), csr.slab_ptr.data_ptr(), csr.slab_ent.data_ptr(),
                             csr.order.data_ptr(), csr.used.data_ptr(), out.data_ptr(), q, u, nnz,
                             m, width, stream())
                    check(err == 0, f"lt_encode slab variant ({lane_cols}, {width}): "
                                    f"cudaError {err}")

                timed(launch, {"engine": "slab", "lane_cols": lane_cols, "width": width,
                               "smem_bytes": smem})
        breakdown = _lt_l2_breakdown(torch, a, csr, iters)
        shipped = None if csr.used is None else lt_slab_plan(q, u, nnz, m,
                                                             _sm_count(dev.index or 0))
        emit({"phase": "sweep lt", "table": which, "q": q, "r": r, "m": m, "nonzeros": nnz,
              "shipped": {"engine": "l2"} if shipped is None else
              {"engine": "slab", "lane_cols": LT_SLAB_LANE_COLS, "width": shipped.width},
              "a_rows_used": u, "heavy_rows": csr.n_heavy,
              "max_degree": int((c_t != 0).sum(1).max()), "variant_build_s": build_s,
              "card": smi, "l2_breakdown": breakdown, "runs": runs,
              "best": min(runs, key=lambda e: e["kernel_ms"])})
        del a, i_t, c_t, want, csr, sparse, out
        torch.cuda.empty_cache()


GAUSS_SWEEP_Q = (16, 26, 32, 33, 48, 64, 96, 128, 256, 564)
GAUSS_SWEEP_R = 500
# the parity raises' shape on the serve paths, G [16, 13] x A [13, br d]
GAUSS_SWEEP_RAISES = (("glm4-9b raise", 16, 13, 11658 * 4096),
                      ("mamba2-130m raise", 16, 13, 3868 * 768))


def sweep_gauss(torch, args, smi: str) -> None:
    """gaussian_encode's two engines at G [q, 500] x A [500, 500,000], the
    Gaussian task's r and m, for each q of GAUSS_SWEEP_Q, and at the parity
    raises' G [16, 13] (GAUSS_SWEEP_RAISES): each held to the plain version
    (1e-4 x max(1, max|plain|)) and timed in turns with torch.matmul
    (register, wide, matmul, matmul, wide, register); one JSON line a
    shape, then the threshold the sweep finds at r = 500: the largest q at
    which the register engine is the faster (the measurement behind
    GAUSSIAN_WIDE_MIN_Q)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lt_encode import GAUSSIAN_WIDE_MIN_Q, gaussian_encode_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    lines = []
    shapes = [(f"q {q}", q, GAUSS_SWEEP_R, PAPER_M) for q in GAUSS_SWEEP_Q]
    for label, q, r, m in [*shapes, *GAUSS_SWEEP_RAISES]:
        if not lines or (r, m) != (lines[-1]["r"], lines[-1]["m"]):
            a = None
            torch.cuda.empty_cache()
            a = torch.randn(r, m, device=dev, generator=gen)
        g = torch.randn(q, r, device=dev, generator=gen) / r ** 0.5
        want = ref.ref_gaussian_encode(g, a)
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        calls = {eng: (lambda eng=eng: gaussian_encode_cuda(g, a, engine=eng))
                 for eng in ("register", "wide")}
        errs = {}
        for eng, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            errs[eng] = max_err(torch, got, want)[0]
            del got
        del want
        order = ("register", "wide", "matmul", "matmul", "wide", "register")
        fns = {**calls, "matmul": lambda: torch.matmul(g, a)}
        turns = [time_ms(torch, fns[k], 10) for k in order]
        ms = {k: sum(t for o, t in zip(order, turns) if o == k) / 2 for k in fns}
        line = {"phase": "sweep gauss", "shape": label, "q": q, "r": r, "m": m,
                "register_ms": ms["register"],
                "wide_ms": ms["wide"], "library_ms": ms["matmul"],
                "ratio_register": ms["register"] / ms["matmul"],
                "ratio_wide": ms["wide"] / ms["matmul"], "turns_ms": turns,
                "max_abs_err": errs, "tol": tol, "card": smi}
        emit(line)
        lines.append(line)
        check(all(e <= tol for e in errs.values()), f"sweep gauss q = {q}: {errs} > {tol}")
        del g
    register_wins = [ln["shape"] for ln in lines if ln["register_ms"] <= ln["wide_ms"]]
    emit({"phase": "sweep gauss",
          "threshold_found": max((ln["q"] for ln in lines if ln["r"] == GAUSS_SWEEP_R
                                  and ln["shape"] in register_wins), default=0),
          "register_wins_at": register_wins, "GAUSSIAN_WIDE_MIN_Q": GAUSSIAN_WIDE_MIN_Q,
          "card": smi})


# (warps, rows a warp, 16-byte words of a row in flight a lane):
# thin_rows.cuh's kWarps, kRowsPerWarp and kLoadsInFlight (words x rows);
# each is timed at 1 and 2 blocks an SM
HEAD_SWEEP = [(8, 1, 8), (8, 2, 6), (8, 4, 6), (16, 1, 8), (16, 2, 6), (16, 2, 4)]
HEAD_BLOCKS_PER_SM = (1, 2)


def _ptxas_summary(log: str) -> dict:
    """Most registers of any entry, and spill bytes over all, in a -Xptxas -v log."""
    import re

    regs = [int(v) for v in re.findall(r"Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    return {"entries": len(regs), "max_registers": max(regs, default=0),
            "spill_bytes": sum(int(a) + int(b) for a, b in spills)}


def _head_variants(settings, max_b: int | None = None) -> dict:
    """thin_rows.cuh rebuilt with other kWarps, kRowsPerWarp and
    kLoadsInFlight (and kMaxB, when ``max_b`` is given), and coded_matvec.cu
    and coded_decode.cu against each copy, one nvcc each, started together,
    under build/head_sweep; {(warps, rows, words, source): (the library, its
    ptxas summary)}, or (None, nvcc's output) for a variant that does not
    build."""
    import ctypes
    import re
    import shutil

    from repro_torch.kernels import _build

    header = (_build.CSRC / "thin_rows.cuh").read_text()
    procs = {}
    for (warps, rows, words), source in itertools.product(settings,
                                                          ("coded_matvec", "coded_decode")):
        text = header
        edits = [("kWarps", warps), ("kRowsPerWarp", rows), ("kLoadsInFlight", words * rows)]
        if max_b is not None:
            edits.append(("kMaxB", max_b))
        for name, value in edits:
            text, n = re.subn(rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};",
                              text)
            check(n == 1, f"thin_rows.cuh defines {name} {n} times, not once")
        tag = f"{source}_c{warps}_r{rows}_w{words}" + ("" if max_b is None else f"_b{max_b}")
        out_dir = _build.BUILD_DIR.parent / "head_sweep" / tag
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "thin_rows.cuh").write_text(text)
        for other in _build.CSRC.glob("*.cuh"):  # the sources' other headers, as they are
            if other.name != "thin_rows.cuh":
                shutil.copy(other, out_dir / other.name)
        cu = out_dir / f"{source}.cu"
        shutil.copy(_build.CSRC / f"{source}.cu", cu)
        lib = cu.with_suffix(".so")
        procs[(warps, rows, words, source)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        libs[key] = ((ctypes.CDLL(str(lib)), _ptxas_summary(log)) if proc.returncode == 0
                     else (None, log[-3000:]))
    return libs


def _head_launch(torch, lib, setting, w, x, rec=None, max_b=None):
    """A launch of a head library's C entry on (w, x[, rec]) with the plan of
    ``setting`` (warps, rows a warp, blocks an SM at most): (the
    zero-argument launch, its output, the plan).  coded_matvec without rec,
    coded_matvec_decode with it.  The plan is head_plan's, with the group of
    rows and the grid's cap of the setting, for a library whose kMaxB is
    ``max_b`` (None: the shipped one's)."""
    import ctypes

    from repro_torch.kernels import thin_rows

    p, i = ctypes.c_void_p, ctypes.c_int
    warps, rows_per_warp, per_sm = setting
    rows, m = w.shape
    x = x.view(m, -1)
    b = x.shape[1]

    def occupancy(*occ_args):
        blocks = ctypes.c_int(0)
        err = occ(*occ_args, ctypes.addressof(blocks))
        check(err == 0, f"head setting {setting}: occupancy query, cudaError {err}")
        return min(per_sm, blocks.value)

    if rec is None:
        half = w.dtype == torch.float16
        vec = m % (8 if half else 4) == 0 and w.data_ptr() % 16 == 0
        occ = lib.coded_matvec_occupancy
        occ.argtypes, occ.restype = [i, i, i, i, p], i
        plan = thin_rows.head_plan(
            rows, m, b, sm_count=thin_rows.sm_count(0), max_b=max_b or thin_rows.MAX_B,
            occupancy=lambda smem: occupancy(b, int(half), int(vec), smem))
        plan = dataclasses.replace(plan, group_rows=warps * rows_per_warp)
        out = torch.empty(rows, b, device=w.device)
        fn = lib.coded_matvec
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, i, i, i, i, i, p]
        args = (w.data_ptr(), x.data_ptr(), out.data_ptr(), rows, m, b, int(half), int(vec))
    else:
        n_data, nb = rec.shape
        vec = m % 4 == 0 and w.data_ptr() % 16 == 0
        occ = lib.coded_matvec_decode_occupancy
        occ.argtypes, occ.restype = [i, i, i, p], i
        plan = thin_rows.head_plan(
            rows, m, b, sm_count=thin_rows.sm_count(0), nb=nb, n_data=n_data,
            max_b=max_b or thin_rows.MAX_B,
            occupancy=lambda smem: occupancy(b, int(vec), smem))
        out = torch.empty(n_data * (rows // nb), b, device=w.device)
        fn = lib.coded_matvec_decode
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, i, i, i, i, i, i,
                       p]
        args = (w.data_ptr(), x.data_ptr(), rec.data_ptr(), out.data_ptr(), rows // nb, m, b, nb,
                n_data, int(vec))
    fn.restype = i
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, plan.grid, plan.group_rows, plan.x_panel, plan.smem_bytes, stream)
        check(err == 0, f"head setting {setting}: cudaError {err}")

    return launch, out, plan


HEAD_REPEAT_PAIRS = 30


def repeat_head(torch, label: str, w, x, rec, iters: int, smi: str) -> None:
    """The shipped head kernel, through its wrapper, against torch.matmul in
    HEAD_REPEAT_PAIRS pairs of turns (``iters`` launches a turn), the order
    alternating between pairs: the pairs the kernel wins, and the median and
    quartiles of the ratio (to tell a gap from the card's run-to-run spread)."""
    import statistics

    from repro_torch.kernels import ops

    if rec is None:
        def kernel():
            return ops.coded_matvec(w, x, mode="cuda")
    else:
        def kernel():
            return ops.coded_matvec_decode(w, x, rec, mode="cuda")
    pairs = []
    for i in range(HEAD_REPEAT_PAIRS):
        order = (kernel, lambda: torch.matmul(w, x))
        t = [time_ms(torch, fn, iters) for fn in (order if i % 2 == 0 else order[::-1])]
        pairs.append(t if i % 2 == 0 else t[::-1])
    ratios = [k / lib for k, lib in pairs]
    q1, median, q3 = statistics.quantiles(ratios, n=4)
    emit({"phase": "repeat head", "shape": label, "b": x.shape[1], "pairs": len(pairs),
          "kernel_wins": sum(k < lib for k, lib in pairs), "median_ratio": median,
          "ratio_quartiles": [q1, q3],
          "kernel_median_ms": statistics.median(k for k, _ in pairs),
          "library_median_ms": statistics.median(lib for _, lib in pairs),
          "pairs_ms": pairs, "card": smi})


def sweep_head(torch, args, smi: str) -> None:
    """Both head kernels at the glm4-9b and Mamba-2 heads' shapes for each
    setting of thin_rows.cuh's register stream (8 warps of 1, 2 and 4 rows,
    16 warps of 1 and 2 rows; words of a row in flight a lane), each a
    variant built here, timed at 1 and 2 blocks an SM (as the occupancy
    allows) in turns with torch.matmul, held to the plain version and to
    the shipped kernel's bits; one JSON line a variant, with its registers
    and spills (or nvcc's output, for a variant that does not build).  First
    the shipped kernel at the B = 1 shapes in repeated pairs of turns
    (repeat_head)."""
    from repro_torch.core.decoding import get_decoder_cache
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    libs = _head_variants(HEAD_SWEEP)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    block = torch.randn(10826, 4096, device=dev, generator=gen)
    wc = torch.randn(16 * 10826, 4096, device=dev, generator=gen)
    rec = get_decoder_cache(14, 2).recovery(torch.ones(16, device=dev))
    x1 = torch.randn(4096, 1, device=dev, generator=gen)
    x4 = torch.randn(4096, 4, device=dev, generator=gen)
    # the Mamba-2 heads' prefill (B = 1): mamba2-130m [16 x 3592, 768], zamba2-1.2b [16 x 2286, 2048]
    heads = {m: (torch.randn(16 * br, m, device=dev, generator=gen),
                 torch.randn(m, 1, device=dev, generator=gen)) for br, m in ((3592, 768),
                                                                             (2286, 2048))}
    cases = [  # label, source, w, x, rec, timed launches a turn
        ("glm4-9b block prefill", "coded_matvec", block, x1, None, 100),
        ("glm4-9b block decode", "coded_matvec", block, x4, None, 100),
        ("glm4-9b block decode fp16", "coded_matvec", block.half(), x4.half(), None, 100),
        ("glm4-9b prefill", "coded_decode", wc, x1, rec, 10),
        ("glm4-9b decode", "coded_decode", wc, x4, rec, 10),
        ("mamba2-130m prefill", "coded_decode", *heads[768], rec, 100),
        ("mamba2-130m decode", "coded_decode", heads[768][0], x4[:768].contiguous(), rec, 100),
        ("zamba2-1.2b prefill", "coded_decode", *heads[2048], rec, 100),
    ]
    shipped = {}
    for label, source, w, x, r, _ in cases:
        if r is None:
            want, got = ref.ref_coded_matvec(w, x), ops.coded_matvec(w, x, mode="cuda")
        else:
            want, got = (ref.ref_coded_matvec_decode(w, x, r),
                         ops.coded_matvec_decode(w, x, r, mode="cuda"))
        tol = (1e-4 if w.dtype == torch.float32 else 2e-3) * max(1.0, float(want.abs().max()))
        shipped[label] = (got, want, tol)
    for label, _, w, x, r, iters in cases:
        if label.endswith("prefill"):  # B = 1, where the kernel and torch.matmul are close
            repeat_head(torch, label, w, x, r, iters, smi)
    for (warps, rows, words), per_sm in itertools.product(HEAD_SWEEP, HEAD_BLOCKS_PER_SM):
        setting = {"warps": warps, "rows_per_warp": rows, "words_in_flight": words,
                   "blocks_per_sm": per_sm}
        built = {source: libs[(warps, rows, words, source)]
                 for source in ("coded_matvec", "coded_decode")}
        failed = {source: log for source, (lib, log) in built.items() if lib is None}
        if failed:
            emit({"phase": "sweep head", **setting, "build_failed": failed})
            continue
        runs = []
        ptxas = {source: summary for source, (_, summary) in built.items()}
        for label, source, w, x, r, iters in cases:
            lib = built[source][0]
            launch, out, plan = _head_launch(torch, lib, (warps, rows, per_sm), w, x, r)
            launch()
            torch.cuda.synchronize()
            got, want, tol = shipped[label]
            err = float((out - want).abs().max())
            ms, library_ms, turns = time_turns(torch, launch, lambda: torch.matmul(w, x),
                                               iters)
            runs.append({"shape": label, "ms": ms, "library_ms": library_ms,
                         "ratio": ms / library_ms, "turns_ms": turns, "grid": plan.grid,
                         "smem_bytes": plan.smem_bytes, "max_abs_err": err, "tol": tol,
                         "bit_equal_shipped": torch.equal(out, got)})
            check(err <= tol, f"head setting {setting} {label}: {err} > {tol}")
            check(runs[-1]["bit_equal_shipped"],
                  f"head setting {setting} {label}: not the shipped kernel's bits")
            del out
        emit({"phase": "sweep head", **setting, "ptxas": ptxas, "card": smi, "runs": runs})
    emit({"phase": "sweep head done", "variant_build_s": build_s,
          "variants": len(HEAD_SWEEP) * len(HEAD_BLOCKS_PER_SM), "libraries": len(libs),
          "card": smi})


# ssd_scan.cu's tensor-core settings: kChunkWarps, kChunkMinBlocks (blocks an
# SM its launch bounds ask for), kFastExp, kCombineWarps, kCombineMinBlocks
WIDE_SWEEP_B = (4, 8, 12, 16, 17)   # widths at which the two head engines are timed
WIDE_SWEEP_TURNS = 3                # pairs of turns (thin, wide, wide, thin) a width
WIDE_SWEEP_THIN_MAX_B = 16          # kMaxB of the sweep's thin-row copy


def sweep_wide(torch, args, smi: str) -> None:
    """The threshold between the head kernels' two engines: the thin-row
    and the wide engine timed in turns (thin, wide, wide, thin, three pairs)
    at B in WIDE_SWEEP_B on the glm4-9b code block (coded_matvec), the
    glm4-9b W_c and the mamba2-130m W_c (coded_matvec_decode).  The wide
    engine runs through its launcher as the wrapper calls it; the thin-row
    engine, which ships for at most WIDE_MIN_B - 1 columns, through a copy
    built here with kMaxB 16 and the shipped setting, on the shipped plan,
    held to the plain version.  At 17 columns it takes two launches (9 + 8
    columns).  Prints each width's times and the smallest width at which
    the wide engine wins at all three shapes, beside ``WIDE_MIN_B``; no
    device line."""
    import re
    import statistics

    from repro_torch.kernels import _build, coded_decode, coded_matvec, ref, thin_rows
    from repro_torch.kernels.wide_rows import WIDE_MIN_B

    words = int(re.search(r"constexpr int kLoadsInFlight = (\d+);",
                          (_build.CSRC / "thin_rows.cuh").read_text()).group(1))
    shipped = (thin_rows.WARPS, thin_rows.ROWS_PER_WARP, words // thin_rows.ROWS_PER_WARP)
    libs = _head_variants([shipped], max_b=WIDE_SWEEP_THIN_MAX_B)
    for source in ("coded_matvec", "coded_decode"):
        lib, log = libs[(*shipped, source)]
        check(lib is not None, f"thin-row copy of {source} with kMaxB "
                               f"{WIDE_SWEEP_THIN_MAX_B} did not build: {log}")
    setting = (*shipped[:2], thin_rows.BLOCKS_PER_SM)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    shapes = [("glm4-9b block", 10826, 4096, None), ("glm4-9b W_c", 10826, 4096, (14, 2)),
              ("mamba2-130m W_c", 3592, 768, (14, 2))]
    wins: dict = {b: [] for b in WIDE_SWEEP_B}
    for label, br, m, code in shapes:
        nb = 1 if code is None else sum(code)
        w = torch.randn(nb * br, m, device=dev, generator=gen)
        rec = None if code is None else torch.randn(code[0], nb, device=dev, generator=gen)
        lib = libs[(*shipped, "coded_matvec" if rec is None else "coded_decode")][0]
        for b in WIDE_SWEEP_B:
            x = torch.randn(m, b, device=dev, generator=gen)
            panels = [x[:, lo:hi].contiguous() for lo, hi in ((0, 9), (9, 17))] if b > 16 else [x]
            runs = [_head_launch(torch, lib, setting, w, p, rec, max_b=WIDE_SWEEP_THIN_MAX_B)
                    for p in panels]

            def thin(runs=runs):
                for launch, _, _ in runs:
                    launch()

            if rec is None:
                def wide(x=x, b=b):
                    coded_matvec._launch_wide(w, x, b)
                want = ref.ref_coded_matvec(w, x)
            else:
                def wide(x=x, b=b):
                    coded_decode._launch_wide(w, x, rec, b)
                want = ref.ref_coded_matvec_decode(w, x, rec)
            thin()
            got = torch.cat([out for _, out, _ in runs], dim=1)
            err, scale = max_err(torch, got, want)
            tol = 1e-4 * max(1.0, scale)
            check(err <= tol, f"sweep_wide thin {label} B={b}: {err} > {tol}")
            del got, want
            iters = 10 if nb * br > 100_000 else 30
            pairs = [time_turns(torch, thin, wide, iters) for _ in range(WIDE_SWEEP_TURNS)]
            thin_ms = statistics.median(p[0] for p in pairs)
            wide_ms = statistics.median(p[1] for p in pairs)
            wins[b].append(wide_ms < thin_ms)
            emit({"phase": "sweep_wide", "shape": label, "w": [nb * br, m], "b": b,
                  "thin_ms": thin_ms, "wide_ms": wide_ms, "thin_launches": len(panels),
                  "wide_over_thin": wide_ms / thin_ms, "thin_max_abs_err": err,
                  "turns_ms": [p[2] for p in pairs], "card": smi})
        del w
        torch.cuda.empty_cache()
    measured = next((b for b in WIDE_SWEEP_B if all(wins[b])), None)
    emit({"phase": "sweep_wide_threshold", "wide_min_b_measured": measured,
          "wide_min_b": WIDE_MIN_B, "agrees": measured == WIDE_MIN_B,
          "wins": {str(b): v for b, v in wins.items()}, "card": smi})


SSD_SWEEP = [(8, 2, 0, 8, 3), (8, 2, 1, 8, 3), (8, 2, 1, 8, 4), (4, 4, 1, 4, 4),
             (4, 2, 0, 4, 6), (16, 1, 1, 16, 1)]
SSD_SWEEP_PROMPTS = (4096, 1000)
SSD_SETTING_NAMES = ("kChunkWarps", "kChunkMinBlocks", "kFastExp", "kCombineWarps",
                     "kCombineMinBlocks")


# the shipped ssd_chunk with a part of its work taken out (its outputs are
# then wrong): each (old, new) replacement of ssd_scan.cu's text must match
# once.  Timed in turns with the shipped kernel, they show where its time goes.
SSD_ABLATIONS = {
    "exp of L taken out": [("return kFastExp ? __expf(v) : expf(v);", "return 1.f;")],
    "one pass, not three": [("for (int k = 0; k < kPieces; ++k) {\n        mma_bf16(acc[2 * pp], pc[k]",
                             "for (int k = 0; k < 1; ++k) {\n        mma_bf16(acc[2 * pp], pc[k]")],
    "no state": [("      chunk_states<kSN>(u / kSplit", "      if (u < 0) chunk_states<kSN>(u / kSplit")],
    "no y_diag": [("    if (it < pl.y_units) {  // the short", "    if (it < 0) {  // the short"),
                  ("      const int u = it - pl.y_units;",
                   "      const int u = it - pl.y_units;\n      if (u < 0) continue;")],
    "staging and cumsum only": [
        ("  for (int it = warp; it < pl.y_units + pl.state_units; it += kChunkWarps) {",
         "  for (int t = 0; t < pl.stages; ++t) mbar_wait(smem_addr(bars + t), 0);\n"
         "  for (int it = warp; it < 0; it += kChunkWarps) {")],
}


def _ssd_variants(settings, ablations) -> dict:
    """ssd_scan.cu rebuilt with other tensor-core settings (SSD_SWEEP) and
    with the ablations named, one nvcc each, started together, under
    build/ssd_sweep; {setting or ablation: (the library, its ptxas
    summary)}, or (None, nvcc's output) for one that does not build."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_scan.cu").read_text()
    texts = {}
    for setting in settings:
        text = src
        for name, value in zip(SSD_SETTING_NAMES, setting):
            text, count = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
            check(count == 1, f"ssd_scan.cu defines {name} {count} times, not once")
        texts[setting] = ("ssd_scan_" + "_".join(map(str, setting)), text)
    for i, name in enumerate(ablations):
        text = src
        for old, new in SSD_ABLATIONS[name]:
            check(text.count(old) >= 1, f"ablation {name!r}: ssd_scan.cu lacks {old!r}")
            text = text.replace(old, new)
        texts[name] = (f"ssd_scan_ablation{i}", text)
    out_dir = _build.BUILD_DIR.parent / "ssd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (stem, text) in texts.items():
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[key] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        libs[key] = ((ctypes.CDLL(str(lib)), _ptxas_summary(log)) if proc.returncode == 0
                     else (None, log[-3000:]))
    return libs


def sweep_ssd(torch, args, smi: str) -> None:
    """The bf16 route of ssd_chunk and ssd_combine at the 4096- and
    1000-token cells of both Mamba-2 widths (reference draw) for each
    tensor-core setting of SSD_SWEEP (warps a block, blocks an SM the launch
    bounds ask for, the exp of L, for each kernel), each a variant of
    ssd_scan.cu built here, timed in turns with the SIMT kernels on bf16 (the
    route before, ssd_*_simt) and held to the plain version's tolerance;
    one JSON line a variant with its registers and spills, and whether its
    bits equal the shipped kernel's."""
    import ctypes

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    t0 = time.perf_counter()
    libs = _ssd_variants(SSD_SWEEP, SSD_ABLATIONS)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    simt_chunk, simt_combine = _ssd_simt(torch)
    cells = []
    for arch, (heads, p, n) in SSD_WIDTHS.items():
        for s in SSD_SWEEP_PROMPTS:
            x, da, b, c = _ssd_cells(torch, gen, heads, p, n, s, torch.bfloat16)
            want = ref.ref_ssd_chunk(x, da, b, c)
            s_in = 0.1 * torch.randn(da.shape[0], p, n, device=dev, generator=gen)
            shipped = (ssd_chunk_cuda(x, da, b, c), ssd_combine_cuda(c, want[3], s_in))
            cells.append((f"{arch} {s}", x, da, b, c, s_in, want,
                          ref.ref_ssd_combine(c, want[3], s_in), shipped))
    vp, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for setting in SSD_SWEEP:
        lib, summary = libs[setting]
        named = dict(zip(("chunk_warps", "chunk_min_blocks", "fast_exp", "combine_warps",
                          "combine_min_blocks"), setting))
        if lib is None:
            emit({"phase": "sweep ssd", **named, "build_failed": summary})
            continue
        chunk, combine = lib.ssd_chunk, lib.ssd_combine
        chunk.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, i, vp]
        combine.argtypes = [vp] * 4 + [ctypes.c_longlong, i, i, i, i, vp]
        chunk.restype = combine.restype = i
        runs = []
        for label, x, da, b, c, s_in, want, want_off, shipped in cells:
            g, q, p = x.shape
            n = b.shape[2]
            out = [torch.empty_like(t) for t in want]
            y_off = torch.empty_like(want_off)
            simt_out = [torch.empty_like(t) for t in want]
            simt_off = torch.empty_like(want_off)

            def run_chunk():
                err = chunk(x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
                            *(t.data_ptr() for t in out), g, q, p, n, 1, stream)
                check(err == 0, f"ssd setting {setting} chunk: cudaError {err}")

            def run_combine():
                err = combine(c.data_ptr(), want[3].data_ptr(), s_in.data_ptr(),
                              y_off.data_ptr(), g, q, p, n, 1, stream)
                check(err == 0, f"ssd setting {setting} combine: cudaError {err}")

            run_chunk()
            run_combine()
            torch.cuda.synchronize()
            checks = [_ssd_check(torch, gv, wv) for gv, wv in zip([*out, y_off],
                                                                  [*want, want_off])]
            chunk_ms, chunk_simt_ms, chunk_turns = time_turns(
                torch, run_chunk, lambda: simt_chunk(x, da, b, c, simt_out), 20)
            comb_ms, comb_simt_ms, comb_turns = time_turns(
                torch, run_combine, lambda: simt_combine(c, want[3], s_in, simt_off), 20)
            runs.append({
                "cells": label, "g": g, "chunk_ms": chunk_ms, "chunk_simt_ms": chunk_simt_ms,
                "chunk_ratio": chunk_ms / chunk_simt_ms, "chunk_turns_ms": chunk_turns,
                "combine_ms": comb_ms, "combine_simt_ms": comb_simt_ms,
                "combine_ratio": comb_ms / comb_simt_ms, "combine_turns_ms": comb_turns,
                "max_err_over_tol": max(err / tol for err, tol, _ in checks),
                "bit_equal_shipped": all(torch.equal(a, b_) for a, b_ in
                                         zip([*out, y_off], [*shipped[0], shipped[1]]))})
            for (err, tol, ok), name in zip(checks, ("y_diag", "states", "decay", "cum",
                                                     "y_off")):
                check(ok, f"ssd setting {setting} {label} {name}: max err {err}, allowed {tol}")
            del out, y_off, simt_out, simt_off
        emit({"phase": "sweep ssd", **named, "ptxas": summary, "card": smi, "runs": runs})
    # where the shipped ssd_chunk's time goes: each ablation in turns with it
    for label, x, da, b, c, s_in, want, want_off, shipped in cells:
        if not label.endswith(str(SSD_TIMED)):
            continue
        g, q, p = x.shape
        n = b.shape[2]
        out = [torch.empty_like(t) for t in want]
        runs = {}
        for name in SSD_ABLATIONS:
            lib, summary = libs[name]
            check(lib is not None, f"ablation {name!r} does not build:\n{summary}")
            fn = lib.ssd_chunk
            fn.argtypes = [vp] * 8 + [ctypes.c_longlong, i, i, i, i, vp]
            fn.restype = i

            def run_ablated(fn=fn):
                fn(x.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(),
                   *(t.data_ptr() for t in out), g, q, p, n, 1, stream)

            ablated_ms, shipped_ms, _ = time_turns(
                torch, run_ablated, lambda: ssd_chunk_cuda(x, da, b, c), 20)
            runs[name] = {"ms": ablated_ms, "shipped_ms": shipped_ms,
                          "saved_ms": shipped_ms - ablated_ms, "spill_bytes": summary["spill_bytes"]}
        emit({"phase": "ablate ssd_chunk", "cells": label, "g": g, "runs": runs, "card": smi})
    emit({"phase": "sweep ssd done", "variant_build_s": build_s, "variants": len(SSD_SWEEP),
          "ablations": len(SSD_ABLATIONS), "card": smi})


MEMORY_SNAPSHOT = "chip_smoke_memory_snapshot.json"


def _allocator(torch, snapshot: bool = False) -> dict:
    """The caching allocator's state: its statistics (bytes allocated,
    reserved, and reserved but free inside split blocks; segments; retries
    and out-of-memory errors) and the device's free bytes; with
    ``snapshot`` a summary of ``torch.cuda.memory_snapshot()`` (segments by
    size, free blocks, the largest), written whole under chiprun_out/."""
    st = torch.cuda.memory_stats()
    keys = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
            "reserved_bytes.all.current", "reserved_bytes.all.peak",
            "inactive_split_bytes.all.current", "inactive_split.all.current",
            "segment.all.current", "num_alloc_retries", "num_ooms", "num_device_alloc",
            "num_device_free")
    out = {k: st.get(k) for k in keys}
    gib = 2 ** 30
    out["reserved_unallocated_gib"] = (st.get("reserved_bytes.all.current", 0)
                                       - st.get("allocated_bytes.all.current", 0)) / gib
    out["free_and_total_gib"] = [x / gib for x in torch.cuda.mem_get_info()]
    out["alloc_conf"] = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if snapshot:
        segs = torch.cuda.memory_snapshot()
        free = sorted((b["size"] for sg in segs for b in sg["blocks"] if b["state"] == "inactive"),
                      reverse=True)
        sizes = sorted((sg["total_size"] for sg in segs), reverse=True)
        out["snapshot"] = {
            "segments": len(segs), "segment_total_gib": sum(sizes) / gib,
            "largest_segments_gib": [x / gib for x in sizes[:12]],
            "segments_with_a_free_block": sum(any(b["state"] == "inactive" for b in sg["blocks"])
                                              for sg in segs),
            "free_blocks": len(free), "free_gib": sum(free) / gib,
            "largest_free_blocks_gib": [x / gib for x in free[:12]],
            "file": f"chiprun_out/{MEMORY_SNAPSHOT}"}
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, MEMORY_SNAPSHOT), "w") as f:
            json.dump([{k: v for k, v in sg.items() if k != "frames"} for sg in segs], f)
    return out


def c2_order(torch, args, smi: str) -> int:
    """Only the order in which the glm4-9b FRC train step (phase 16) once
    ran out of memory: the vlm, moe and encdec serves, then phase 16, with
    the allocator's state printed between them.  At an out-of-memory error
    it prints the error, the allocator's statistics and a summary of its
    snapshot, and returns 1; else 0.  No device line."""
    results: dict = {}
    try:
        for arch in FAMILY_ARCHS:
            phase_family_serve(torch, args, results, smi, arch)
        phase_encdec_serve(torch, args, results, smi)
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "c2 allocator before train glm4-9b", **_allocator(torch)})
        phase_train_glm(torch, args, results, smi)
    except torch.OutOfMemoryError as err:
        emit({"phase": "c2 out of memory", "error": str(err)[:600],
              **_allocator(torch, snapshot=True)})
        return 1
    emit({"phase": "c2 passed", **_allocator(torch)})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="glm4-9b depth to serve (40 = full; widths are never cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler window over 3 engine steps")
    ap.add_argument("--sweep-lt", action="store_true",
                    help="only build, check the encode kernels and sweep lt_encode's two "
                         "engines: the L2 engine's span width, light rows a unit and heavy "
                         "split at the whole LT plan, the slab engine's lane columns and "
                         "span width at the EC2 example's tables (no serve, no device line)")
    ap.add_argument("--sweep-gauss", action="store_true",
                    help="only build, check the encode kernels and time gaussian_encode's "
                         "register and tensor-core engines at q = 16 to 564, r = 500, "
                         "m = 500,000 in turns with torch.matmul (GAUSSIAN_WIDE_MIN_Q; no "
                         "serve, no device line)")
    ap.add_argument("--sweep-ssd", action="store_true",
                    help="only build, check the SSD kernels and sweep ssd_scan.cu's "
                         "tensor-core settings at the 4096- and 1000-token Mamba-2 cells, "
                         "in turns with the SIMT kernels (no serve, no device line)")
    ap.add_argument("--sweep-head", action="store_true",
                    help="only build, check the head kernels and sweep thin_rows.cuh's "
                         "warps, rows a warp, loads in flight and blocks an SM at the "
                         "glm4-9b and Mamba-2 heads' shapes (no serve, no device line)")
    ap.add_argument("--sweep-wide", action="store_true",
                    help="only build, check the head kernels and time the thin-row and the "
                         "wide engine at B = 4, 8, 12, 16 and 17 on the glm4-9b block, the "
                         "glm4-9b W_c and the mamba2-130m W_c (no serve, no device line)")
    ap.add_argument("--prefill-attn", action="store_true",
                    help="only build, check and time the prefill attention kernel at glm4-9b's "
                         "heads and serve longprompt-shaped glm4-9b prompts through it and "
                         "through the plain path (no device line)")
    ap.add_argument("--c2-order", action="store_true",
                    help="only the vlm, moe and encdec serves, then the glm4-9b train phase, "
                         "with the allocator's state (at an out-of-memory error, its "
                         "statistics and snapshot; no device line)")
    args = ap.parse_args()

    # before CUDA initialises: segments that grow in place, so memory freed
    # between phases is not left split into blocks too small for a later
    # phase's tensors (the caller's setting, where there is one, holds)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
        sweep_lt(torch, args, smi)
        return 0
    if args.sweep_gauss:
        kernel_gaussian(torch, gen, results)
        sweep_gauss(torch, args, smi)
        return 0
    if args.sweep_ssd:
        kernel_ssd(torch, results)
        sweep_ssd(torch, args, smi)
        return 0
    if args.sweep_head:
        kernel_coded_decode(torch, gen, results)
        kernel_coded_matvec(torch, gen, results)
        sweep_head(torch, args, smi)
        return 0
    if args.sweep_wide:
        kernel_coded_decode(torch, gen, results)
        kernel_coded_matvec(torch, gen, results)
        sweep_wide(torch, args, smi)
        return 0
    if args.prefill_attn:
        kernel_prefill_attn(torch, results)
        phase_prefill_serve(torch, args, results, smi)
        return 0
    if args.c2_order:
        return c2_order(torch, args, smi)
    seconds: dict = {}

    def timed(name: str, fn, *fn_args):
        t0 = time.perf_counter()
        try:
            out = fn(*fn_args)
        except torch.OutOfMemoryError as err:  # the allocator's state at the failure
            emit({"phase": "out of memory", "in": name, "error": str(err)[:600],
                  **_allocator(torch, snapshot=True)})
            raise
        seconds[name] = time.perf_counter() - t0
        return out

    timed("kernels", phase_kernels, torch, gen, results)
    timed("task lt", phase_task_lt, torch, args, results, smi)
    timed("task gaussian", phase_task_gaussian, torch, args, results, smi)
    timed("ec2 example", phase_ec2_example, torch, args, results, smi)
    timed("prefill serve", phase_prefill_serve, torch, args, results, smi)
    serve = timed("serve glm4-9b", phase_serve, torch, args, results, smi)
    mesh = _head_mesh(torch)
    timed("mesh head", phase_mesh_head, torch, serve, mesh,
          torch.Generator(device="cuda").manual_seed(args.seed + 2), results, smi)
    timed("mesh serve", phase_mesh_serve, torch, serve, mesh, results, smi)
    timed("trace serve", phase_trace_serve, torch, args, serve, results, smi)
    timed("macro glm4-9b", phase_macro_glm, torch, serve, results, smi)
    timed("macro glm4-9b svd", phase_macro_svd, torch, serve, results, smi)
    timed("wide glm4-9b", phase_wide_glm, torch, args, serve, mesh, results, smi)
    timed("auto glm4-9b", phase_auto_glm, torch, args, serve, mesh, results, smi)
    del serve, mesh
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SSD_WIDTHS:
        timed(f"serve {arch}", phase_mamba_serve, torch, args, results, smi, arch)
    for arch in FAMILY_ARCHS:
        timed(f"serve {arch}", phase_family_serve, torch, args, results, smi, arch)
    timed("serve seamless-m4t-large-v2", phase_encdec_serve, torch, args, results, smi)
    timed("dryrun", phase_dryrun, torch, args, results, smi)
    timed("train glm4-9b", phase_train_glm, torch, args, results, smi)
    timed("train zamba2-1.2b", phase_train_zamba, torch, args, results, smi)
    timed("train drill", phase_train_drill, torch, args, results, smi)
    for arch in FAMILY_TRAIN:
        timed(f"train {arch}", phase_train_family, torch, args, results, smi, arch)
    emit({"phase": "seconds", **seconds})

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
        ("lt_encode", "src/repro_torch/kernels/csrc/lt_encode.cu",
         "src/repro/kernels/lt_encode.py:61", "ec2 example", results["ec2 example"],
         "ec2 example"),
        ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
         "src/repro/kernels/coded_matvec.py:47", "mesh head", results["mesh_head"],
         "glm4-9b block decode"),
        ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
         "src/repro/kernels/coded_matvec.py:47", "mesh serve", results["mesh_serve"],
         "glm4-9b block decode"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "mesh serve", results["mesh_serve"],
         "glm4-9b raise"),
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "trace serve", results["trace_serve"],
         "glm4-9b decode"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "trace serve", results["trace_serve"],
         "glm4-9b raise"),
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "macro serve (graphs)",
         {"launches": results["macro glm4-9b"]["launches"][1]}, "glm4-9b decode"),
        *((name, src, replaces, f"svd macro serve (graphs), {pair}",
           {"launches": results["macro glm4-9b svd"][pair]["launches"][1]}, shape)
          for pair, name, src, replaces, shape in (
              ("(10, 6)", "masked_pinv", "src/repro_torch/kernels/csrc/masked_pinv.cu",
               SVD_REPLACES, "glm4-9b (10, 6) head"),
              ("(10, 6)", "coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "glm4-9b decode (10, 6)"),
              ("svd", "masked_pinv", "src/repro_torch/kernels/csrc/masked_pinv.cu",
               SVD_REPLACES, "glm4-9b (14, 2) svd"),
              ("svd", "coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "glm4-9b decode"))),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "svd macro serve, (10, 6) re-encode",
         results["macro glm4-9b svd"]["encode"], "glm4-9b (10, 6) encode"),
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "wide glm4-9b serve", results["wide glm4-9b"],
         "glm4-9b decode B=64"),
        ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
         "src/repro/kernels/lt_encode.py:107", "wide glm4-9b serve", results["wide glm4-9b"],
         "glm4-9b raise"),
        ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
         "src/repro/kernels/coded_matvec.py:47", "wide glm4-9b mesh serve",
         results["wide glm4-9b mesh"], "glm4-9b block B=64"),
        ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
         "src/repro/kernels/coded_decode.py:65", "wide glm4-9b macro serve (graphs)",
         {"launches": results["macro glm4-9b x64"]["launches"][1]}, "glm4-9b decode B=64"),
        *((name, src, replaces, "auto glm4-9b", results["auto glm4-9b"], shape)
          for name, src, replaces, shape in (
              ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "glm4-9b decode"),
              ("coded_matvec", "src/repro_torch/kernels/csrc/coded_matvec.cu",
               "src/repro/kernels/coded_matvec.py:47", "glm4-9b block decode"),
              ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
               "src/repro/kernels/lt_encode.py:107", "glm4-9b raise"),
              ("lt_encode", "src/repro_torch/kernels/csrc/lt_encode.cu",
               "src/repro/kernels/lt_encode.py:61", "task reserve slice"))),
        *((name, src, replaces, f"{arch} macro serve (graphs)",
           {"launches": results[f"macro {arch}"]["launches"][1]}, shape)
          for arch in ("mamba2-130m", "zamba2-1.2b")
          for name, src, replaces, shape in (
              ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:52", f"{arch} {SSD_TIMED} bfloat16"),
              ("ssd_combine", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:99", f"{arch} {SSD_TIMED} bfloat16"),
              ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", f"{arch} decode"),
              ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
               "src/repro/kernels/lt_encode.py:107", f"{arch} raise"))),
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
        *((name, src, replaces, path, phase, f"{arch} {shape}")
          for arch, fam in FAMILY_ARCHS.items()
          for path, phase in ((f"{fam} serve", results[f"serve {arch}"]),
                              (f"{arch} macro serve (graphs)",
                               {"launches": results[f"macro {arch}"]["launches"][1]}))
          for name, src, replaces, shape in (
              ("coded_matvec_decode", "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "decode"),
              ("gaussian_encode", "src/repro_torch/kernels/csrc/gaussian_encode.cu",
               "src/repro/kernels/lt_encode.py:107", "raise"))),
        *((name, src, replaces, f"{fam} train", results[phase_key], shape)
          for phase_key, fam, shape in (
              ("train zamba2-1.2b", "hybrid",
               f"zamba2-1.2b train {TRAIN_BATCH // TRAIN_MICRO}x{TRAIN_ZAMBA_SEQ} bfloat16"),
              ("train drill", "ssm",
               f"mamba2-130m train {TRAIN_BATCH // TRAIN_MICRO}x{TRAIN_DRILL_SEQ} bfloat16"))
          for name, src, replaces in (
              ("ssd_chunk", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:52"),
              ("ssd_combine", "src/repro_torch/kernels/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:99"))),
        *((name, src, replaces, cell, results[cell], shape)
          for cell, name, src, replaces, shape in (
              ("dryrun-glm4-9b-decode_32k-coded", "coded_matvec_decode",
               "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "glm4-9b decode B=8"),
              ("dryrun-mamba2-130m-decode_32k-coded", "coded_matvec_decode",
               "src/repro_torch/kernels/csrc/coded_decode.cu",
               "src/repro/kernels/coded_decode.py:65", "mamba2-130m decode B=128"),
              *((cell, name, "src/repro_torch/kernels/csrc/ssd_scan.cu", replaces, shape)
                for cell, shape in (("dryrun-zamba2-1.2b-prefill_32k",
                                     "zamba2-1.2b 32768 bfloat16"),
                                    ("dryrun-mamba2-130m-train_4k",
                                     "mamba2-130m train 8x4096 bfloat16"))
                for name, replaces in (("ssd_chunk", "src/repro/kernels/ssd_scan.py:52"),
                                       ("ssd_combine", "src/repro/kernels/ssd_scan.py:99"))))),
        ("prefill_attn", "src/repro_torch/kernels/csrc/prefill_attn.cu", PREFILL_REPLACES,
         "prefill serve", results["prefill serve"], "glm4-9b S=1024"),
    ):
        r = results[name][shape]
        launches = phase.get("device_encode", phase)["launches"]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": r["max_abs_err"],
                 # the engine the timed row ran (gaussian_encode: register or
                 # wide; lt_encode: slab or l2), and of the launches the
                 # second engine's (wide or slab; None where the kernel has
                 # one engine)
                 "engine": r.get("engine"),
                 "wide_launches": launches.get(f"{name}_wide"),
                 "slab_launches": launches.get(f"{name}_slab"),
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
        json.dump({"card": smi, "seconds": seconds, "results": results, "kernels": kernels}, f,
                  indent=1)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
