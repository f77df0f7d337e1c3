"""Serving launcher: batched decode with the BPCC coded head, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --coded
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --coded

``--arch`` takes any of the ten configs (``repro_torch.configs.ARCHS``):
dense, moe, ssm, hybrid and encdec serve synthetic prompts (an encdec
request gets zero source frames of its prompt's length, as the reference's
engine gives); a vlm config is refused with a ``ValueError``, since its
requests need image embeddings (``Request.img_embed``) that this launcher
does not make, and the reference's launcher fails there too.

Continuous batching (``serve.engine.ServeEngine``) over a pre-loaded queue
of ``--requests`` synthetic prompts, or with ``--trace poisson|bursty`` over
an open-loop arrival trace with deadlines and admission control
(``serve.scheduler.TraceScheduler``), driven on the wall clock.  With
``--coded`` the LM-head matvec runs on the block-coded head: on CUDA as the
fused hand-written kernel, on the CPU as its plain version.
``--straggler-prob`` drops up to ``--parity`` random shards per step and
the logits stay exact; with ``--adaptive-parity`` the shards dropped per
step follow the straggler posterior (``core.adaptive.ParityController``)
over latencies seen through a ``runtime.HealthMonitor``, and with
``--deadline-parity`` also the trace's SLO slack.  ``--macro-steps K``
decodes up to K steps a block at batch-full steady state, one CUDA graph a
block on the card.  Params come from a seeded init on the device.
``--dry-run`` prints the resolved configuration and exits.  Trace mode
runs the engine with a tracer (``utils.trace``) and prints why each
``macro_step()`` ran scalar or fused, the share of the KV cache in use, and
the engine's and the model's spans with their attributes.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded --device cpu \\
        --straggler-prob 0.25 --adaptive-parity --trace poisson --rate 4 \\
        --requests 10 --max-new 8 --deadline-parity --slo-factor 40 \\
        --t-token-est 0.3 --macro-steps 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Batched LM serving with the BPCC coded head (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    ap.add_argument("--arch", default="glm4-9b",
                    help="model architecture id (see repro_torch.configs.ARCHS)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model config (2 layers, narrow widths)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of synthetic requests to serve")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching decode slots (batch size)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="tokens per synthetic prompt")
    ap.add_argument("--max-new", type=int, default=32,
                    help="max new tokens generated per request")
    ap.add_argument("--s-max", type=int, default=128,
                    help="KV-cache capacity (max sequence length) per slot")
    ap.add_argument("--coded", action="store_true",
                    help="BPCC coded LM head (straggler-tolerant logits)")
    ap.add_argument("--parity", type=int, default=2,
                    help="parity shards of the coded head (erasure budget)")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="per-step probability each shard's result is lost")
    ap.add_argument("--adaptive-parity", action="store_true",
                    help="pick the per-step parity level from the online "
                         "straggler posterior instead of always dropping the "
                         "full parity budget")
    ap.add_argument("--trace", choices=["none", "poisson", "bursty"], default="none",
                    help="open-loop arrival trace: requests arrive over wall-clock "
                         "time with deadlines and admission control, instead of "
                         "a pre-loaded queue")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="trace mode: mean arrival rate, requests/second")
    ap.add_argument("--slo-factor", type=float, default=4.0,
                    help="trace mode: per-token deadline budget as a multiple "
                         "of the nominal step time")
    ap.add_argument("--t-token-est", type=float, default=0.05,
                    help="trace mode: nominal per-token wall-clock seconds used "
                         "to size deadlines (EW-corrected online)")
    ap.add_argument("--deadline-parity", action="store_true",
                    help="trace mode + --adaptive-parity: escalate the parity "
                         "level from SLO slack (DeadlineAwareParity)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="trace mode: SLO classes; N > 1 splits traffic into N "
                         "weighted-fair-queued tenants with geometrically "
                         "decaying weights and tightening deadline factors")
    ap.add_argument("--tenant-parity", action="store_true",
                    help="with --deadline-parity and --tenants > 1: per-class "
                         "slack -> parity escalation (TenantDeadlineParity)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="trace mode: prompt tokens the engine may prefill per "
                         "step; default refills every free slot")
    ap.add_argument("--macro-steps", type=int, default=1,
                    help="fused macro-step decode K_max: up to K steps a block "
                         "with one host sync at batch-full steady state (one "
                         "CUDA graph a block on the card); 1 keeps every step "
                         "scalar")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of params, prompts and straggler draws")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved config and exit without executing")
    args = ap.parse_args(argv)
    if args.adaptive_parity and not (args.coded and args.straggler_prob > 0):
        ap.error("--adaptive-parity requires --coded and --straggler-prob > 0 "
                 "(there is no straggler posterior to adapt to otherwise)")
    if args.deadline_parity and not (args.adaptive_parity and args.trace != "none"):
        ap.error("--deadline-parity requires --adaptive-parity and --trace "
                 "(SLO slack only exists under a deadline-bearing trace)")
    if args.tenants < 1:
        ap.error("--tenants must be >= 1")
    if args.tenant_parity and not (args.deadline_parity and args.tenants > 1):
        ap.error("--tenant-parity requires --deadline-parity and --tenants > 1")
    if args.macro_steps < 1:
        ap.error("--macro-steps must be >= 1")

    from repro_torch.configs import get_config
    from repro_torch.models.config import coded_blocks

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.coded:
        cfg = cfg.scaled(coded=True, coded_parity=args.parity)
    n_shards = coded_blocks(cfg)

    if args.dry_run:
        n_params, _ = cfg.param_count()
        print("[serve] --dry-run resolved config:")
        print(f"  arch={cfg.name} family={cfg.family} smoke={args.smoke} "
              f"params~{n_params:,.0f} device={args.device}")
        print(f"  d_model={cfg.d_model} n_layers={cfg.n_layers} vocab={cfg.vocab}")
        print(f"  engine: slots={args.slots} s_max={args.s_max} "
              f"requests={args.requests} prompt_len={args.prompt_len} "
              f"max_new={args.max_new} macro_steps={args.macro_steps}")
        print(f"  coded={cfg.coded} parity={cfg.coded_parity if cfg.coded else 0} "
              f"shards={n_shards} straggler_prob={args.straggler_prob} "
              f"adaptive_parity={args.adaptive_parity}")
        if args.trace != "none":
            print(f"  traffic: trace={args.trace} rate={args.rate}/s "
                  f"slo_factor={args.slo_factor} t_token_est={args.t_token_est}s "
                  f"deadline_parity={args.deadline_parity} "
                  f"tenants={args.tenants} tenant_parity={args.tenant_parity} "
                  f"prefill_budget={args.prefill_budget}")
        return

    if cfg.family == "vlm":
        raise ValueError(
            f"{cfg.name}: vision requests need img_embed (precomputed image embeddings), "
            "which this launcher does not supply; serve it through ServeEngine with "
            "Request(img_embed=...)")

    import torch

    from repro_torch import default_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    device = default_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)

    rng = np.random.default_rng(args.seed)
    mask_fn = None
    latency_fn = None
    controller = None
    if args.coded and args.straggler_prob > 0:
        if args.adaptive_parity:
            # synthetic per-shard latencies with randomly straggling shards,
            # seen through the HealthMonitor's EW estimator: the mask comes
            # from backward-looking estimates, the posterior decides how many
            # laggards to drop each step
            from repro_torch.core.adaptive import ParityController
            from repro_torch.runtime import HealthMonitor

            monitor = HealthMonitor(n_workers=n_shards)

            def latency_fn():
                lat = 1e-3 * (1.0 + 0.1 * rng.random(n_shards))
                slow = rng.random(n_shards) < args.straggler_prob
                lat[slow] *= 50.0
                monitor.observe_step_latencies(lat)
                return monitor.shard_latencies()

            controller = ParityController(n_shards)
        else:
            def mask_fn():
                m = np.ones(n_shards)
                drop = rng.random(n_shards) < args.straggler_prob
                # never drop more than the parity budget
                m[np.flatnonzero(drop)[: args.parity]] = 0.0
                return m

    if args.trace != "none":
        trace_mode(args, cfg, model, params, rng, device, mask_fn, latency_fn, controller)
        return

    eng = ServeEngine(model, params, n_slots=args.slots, s_max=args.s_max,
                      mask_fn=mask_fn, latency_fn=latency_fn,
                      parity_controller=controller, macro_steps=args.macro_steps,
                      device=device)
    del params  # the engine holds what it needs
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    syncs_per_tok = eng.sync_count / max(eng.tokens_emitted, 1)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:,.1f} tok/s) on {device} coded={args.coded} "
          f"straggler_prob={args.straggler_prob} "
          f"adaptive_parity={controller is not None} "
          f"macro_steps={args.macro_steps} "
          f"host_syncs/token={syncs_per_tok:.3f}")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}...")


def trace_mode(args, cfg, model, params, rng, device, mask_fn, latency_fn, controller) -> None:
    """Open-loop arrivals with deadlines: a ``TraceScheduler`` admits
    requests as the wall clock passes their arrival, the engine decodes,
    and an idle engine sleeps to the next arrival."""
    from repro_torch.core.adaptive import DeadlineAwareParity, TenantDeadlineParity
    from repro_torch.serve import (
        Request,
        ServeEngine,
        SLOClass,
        TraceScheduler,
        bursty_trace,
        poisson_trace,
    )
    from repro_torch.utils.trace import Tracer, report_lines

    classes = None
    if args.tenants > 1:
        # premium tenants: higher WFQ weight, tighter per-token SLO, slacker
        # escalation (they start hedging earlier)
        classes = tuple(
            SLOClass(name=f"t{c}", weight=2.0 ** (args.tenants - 1 - c),
                     slo_factor=args.slo_factor * (1.0 + 0.5 * c),
                     share=1.0, escalate_steps=8.0 * (1.0 + c))
            for c in range(args.tenants)
        )
    mk = poisson_trace if args.trace == "poisson" else bursty_trace
    trace = mk(args.rate, args.requests, seed=args.seed,
               mean_tokens=args.max_new, max_tokens=args.max_new,
               t_token=args.t_token_est, slo_factor=args.slo_factor,
               classes=classes)
    payloads = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new_tokens=int(trace.n_tokens[i]))
        for i in range(trace.n_requests)
    ]
    sched = TraceScheduler(trace, args.slots, t_step_init=args.t_token_est,
                           payloads=payloads)
    policy = None
    if args.deadline_parity and controller is not None:
        policy = (TenantDeadlineParity(controller, classes=trace.classes)
                  if args.tenant_parity
                  else DeadlineAwareParity(controller))
    t0 = time.monotonic()
    clock = lambda: time.monotonic() - t0  # noqa: E731
    tracer = Tracer()
    eng = ServeEngine(model, params, n_slots=args.slots, s_max=args.s_max,
                      mask_fn=mask_fn, latency_fn=latency_fn,
                      parity_controller=controller, parity_policy=policy,
                      scheduler=sched, clock=clock,
                      prefill_budget=args.prefill_budget,
                      macro_steps=args.macro_steps, device=device, tracer=tracer)
    del params
    while not sched.finished:
        if eng.macro_step() == 0:
            nxt = sched.next_arrival()
            if nxt is None:
                break
            time.sleep(max(0.0, nxt - clock()))
    res = sched.results()
    dt = clock()
    n_tok = int(res["n_tokens"][np.isfinite(res["t_complete"])].sum())
    syncs_per_tok = eng.sync_count / max(eng.tokens_emitted, 1)
    print(f"[serve] trace={args.trace} {trace.n_requests} requests, "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):,.1f} tok/s) on {device}")
    print(f"  SLO attainment {res['slo_met'].mean():.1%}  "
          f"rejected {int(res['rejected'].sum())}  "
          f"est_step {sched.est_step_time * 1e3:.1f} ms  "
          f"deadline_parity={policy is not None}")
    print(f"  macro_steps={args.macro_steps}  fused_blocks={eng.macro_blocks}  "
          f"host_syncs/token={syncs_per_tok:.3f}")
    # why each macro_step() ran scalar or fused, and the share of the KV
    # cache's bytes its live positions held, averaged over decoded steps
    c = eng.counters
    why = " ".join(f"{k[len('choose_k.'):]}={n}" for k, n in c.items()
                   if k.startswith("choose_k.") and n)
    in_use = c["kv.live_bytes"] / max(c["kv.steps"] * c["kv.reserved_bytes"], 1)
    print(f"  choose_k: {why}  kv_in_use={in_use:.1%}")
    # where the engine's host time went: its spans, set-up's included
    for line in report_lines(tracer.spans):
        print("  " + line)
    if args.tenants > 1:
        for c, cls in enumerate(trace.classes):
            sel = res["tenant"] == c
            att = res["slo_met"][sel].mean() if sel.any() else 1.0
            print(f"  class {cls.name}: weight={cls.weight:g} "
                  f"n={int(sel.sum())} attainment {att:.1%}")


if __name__ == "__main__":
    main()
