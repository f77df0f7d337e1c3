"""Serving launcher: batched decode with the BPCC coded head, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --coded
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --coded --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --coded

``--arch`` takes the dense glm4-9b and phi3-mini-3.8b, the Mamba-2
mamba2-130m and the hybrid zamba2-1.2b (``repro_torch.configs.ARCHS``).

Continuous batching (``serve.engine.ServeEngine``) over a pre-loaded queue
of ``--requests`` synthetic prompts.  With ``--coded`` the LM-head matvec
runs on the block-coded head: on CUDA as the fused hand-written kernel, on
the CPU as its plain version.  ``--straggler-prob`` drops up to
``--parity`` random shards per step and the logits stay exact.  Params come
from a seeded init on the device.  ``--dry-run`` prints the resolved
configuration and exits.
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
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of params, prompts and straggler draws")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on ('cuda' or 'cpu')")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved config and exit without executing")
    args = ap.parse_args(argv)

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
              f"max_new={args.max_new}")
        print(f"  coded={cfg.coded} parity={cfg.coded_parity if cfg.coded else 0} "
              f"shards={n_shards} straggler_prob={args.straggler_prob}")
        return

    import torch

    from repro_torch import default_device
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    device = default_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), device)

    rng = np.random.default_rng(args.seed)
    mask_fn = None
    if args.coded and args.straggler_prob > 0:
        def mask_fn():
            m = np.ones(n_shards)
            drop = rng.random(n_shards) < args.straggler_prob
            # never drop more than the parity budget
            m[np.flatnonzero(drop)[: args.parity]] = 0.0
            return m

    eng = ServeEngine(model, params, n_slots=args.slots, s_max=args.s_max,
                      mask_fn=mask_fn, device=device)
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
          f"host_syncs/token={syncs_per_tok:.3f}")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.out_tokens[:10]}...")


if __name__ == "__main__":
    main()
