"""End-to-end training launcher, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --layers 2 \\
        --steps 100 --batch 8 --seq 512 --microbatches 4 --lr 1e-4
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 20 --batch 8 --seq 16 --microbatches 4 --gradient-coding cyclic \\
        --compress int8 --adaptive-s --straggler-prob 0.2 \\
        --ckpt-dir "${TMPDIR:-/tmp}/ck-$$"

Port of ``repro.launch.train``: data pipeline -> train step (microbatching,
remat, optional coded gradient aggregation) -> AdamW (int8 moments
optional) -> atomic checkpoints with restart, health-monitor hooks.
``--arch`` takes all ten configs (``repro_torch.configs.ARCHS``): dense,
moe, ssm, hybrid, vlm and encdec.  ``--layers`` cuts the depth (widths are
never cut): it must be a whole number of the model's layer groups (5 for
llama-3.2-vision-11b, whose fifth layer carries the image cross-attention;
2 for llama4-maverick), and for an encoder-decoder it is the decoder's
depth (the encoder keeps its own).  vlm batches carry the pipeline's seeded
image embeddings, encdec batches its seeded source frames.  Params come
from a seeded init on the device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-vision-11b \
        --layers 5 --steps 10 --batch 8 --seq 512 --microbatches 4 --lr 1e-4 \
        --moment-dtype int8
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --layers 1 \
        --steps 10 --batch 4 --seq 512 --lr 1e-4 --moment-dtype int8

Coded mode adds the straggler-robust path:

  * per-step masks from a two-state Markov straggler stream
    (``cluster.straggler.MarkovStragglerPolicy``): with replication s the
    master waits for the first m−s coded messages, so the mask drops the s
    realized-slowest workers;
  * ``--adaptive-s``: the replication level is re-chosen online per step by
    ``core.adaptive.ReplicationController`` from the observed per-worker
    latencies (a train step is built per level and kept);
  * ``--compress int8``: error-feedback int8 quantization of the coded
    messages, residuals carried in state["err"];
  * ``--kill-at N``: device-death drill on a grid of ``--logical-devices``
    logical devices (one card): the last DP slice dies at step N, its
    workers' messages (worker w sits on slice w mod DP) stop arriving,
    unrecoverable masks are *skipped* (params untouched), and after
    ``--detect-steps`` consecutive skips the elastic protocol runs:
    ``shrink_mesh`` -> ``restore_checkpoint`` -> training resumes.  Whether
    a dead slice is unrecoverable is the code's budget: FRC at s = 0, or
    cyclic with fewer survivors than m − s.

``--dry-run`` prints the resolved configuration and exits.  ``main``
returns the run's record (per-step loss and ok, the elastic events, the
final state) for callers in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _allowed_levels(kind: str, m: int, s_max: int) -> list[int]:
    """Replication levels the adaptive controller may pick from."""
    if kind == "frc":
        return [s for s in range(0, min(s_max, m - 1) + 1) if m % (s + 1) == 0]
    return list(range(0, min(s_max, m - 1) + 1))


def _depth(cfg) -> str:
    """The depth as printed: an encoder-decoder names both stacks."""
    if cfg.family == "encdec":
        return f"{cfg.n_layers} (decoder; encoder {cfg.enc_layers})"
    return str(cfg.n_layers)


def cut_depth(cfg, layers: int):
    """``cfg`` with ``n_layers = layers`` (for an encoder-decoder the decoder's
    depth).  Raises ValueError unless ``layers`` is a positive multiple of
    the model's layer group (``group_period``): a cut inside a group would
    build fewer groups than asked, none below one group."""
    from repro_torch.models.transformer import group_period

    period = group_period(cfg)
    if layers < 1 or layers % period:
        raise ValueError(f"--layers {layers}: {cfg.name} stacks its layers in groups of "
                         f"{period}; the depth must be a positive multiple of {period}")
    return cfg.scaled(n_layers=layers)


def make_local_mesh(n_devices: int, model: int | None = None):
    """The (data, model) grid of ``n_devices`` logical devices: TP the
    widest power of two up to 16 that divides them, unless named."""
    from repro_torch.runtime.elastic import make_mesh_from_devices

    if model is None:
        model = 1
        while model * 2 <= n_devices and n_devices % (model * 2) == 0 and model < 16:
            model *= 2
    elif n_devices % model != 0:
        raise ValueError(f"--mesh-model {model} does not divide {n_devices} devices")
    return make_mesh_from_devices(range(n_devices), (n_devices // model, model),
                                  ("data", "model"))


def main(argv: list[str] | None = None) -> dict | None:
    ap = argparse.ArgumentParser(
        description="End-to-end LM training with coded gradient aggregation (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    ap.add_argument("--arch", default="glm4-9b",
                    help="model architecture id (see repro_torch.configs.ARCHS)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model config (2-4 layers, narrow widths)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers (widths kept; a "
                         "multiple of the layer group; encdec: the decoder's depth)")
    ap.add_argument("--steps", type=int, default=100,
                    help="training steps to run")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch size (sequences per step)")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length in tokens")
    ap.add_argument("--lr", type=float, default=3e-3,
                    help="peak learning rate (warmup-cosine schedule)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches per step "
                         "(= coded workers in gradient-coding mode)")
    ap.add_argument("--logical-devices", type=int, default=1,
                    help="logical devices of the (data, model) grid on the card")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="TP width of the logical grid (default: widest that "
                         "fits; set small to leave DP slices for the drill)")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"],
                    help="AdamW moment storage dtype (int8 quarters the moments)")
    ap.add_argument("--gradient-coding", default=None, choices=[None, "frc", "cyclic"],
                    help="coded gradient aggregation scheme across microbatches")
    ap.add_argument("--gc-stragglers", type=int, default=1,
                    help="straggler budget s (maximum level when --adaptive-s)")
    ap.add_argument("--adaptive-s", action="store_true",
                    help="re-choose the replication level online from the "
                         "ReplicationController's latency posterior")
    ap.add_argument("--compress", default=None, choices=[None, "int8"],
                    help="error-feedback compression of the coded messages")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="stationary straggler fraction of the Markov "
                         "injection (paper §5.3.1 uses 0.2)")
    ap.add_argument("--straggler-slowdown", type=float, default=3.0,
                    help="compute-time multiplier while slow (paper: 3x)")
    ap.add_argument("--straggler-persistence", type=float, default=25.0,
                    help="mean steps a slow regime lasts")
    ap.add_argument("--straggler-onset", type=float, default=None,
                    help="per-step onset probability (overrides --straggler-prob)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="device-death drill: the last DP slice dies at this "
                         "step; elastic shrink/restore resumes training")
    ap.add_argument("--detect-steps", type=int, default=2,
                    help="consecutive unrecoverable steps before the death "
                         "drill declares the slice dead and re-grids")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (None disables checkpointing)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save an (async, atomic) checkpoint every N steps")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print loss/throughput every N steps")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed (init, data pipeline, straggler draws)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved config and exit without executing")
    args = ap.parse_args(argv)

    if args.kill_at is not None and not args.ckpt_dir:
        ap.error("--kill-at needs --ckpt-dir (restore after the re-grid)")
    if args.kill_at is not None and not args.gradient_coding:
        ap.error("--kill-at needs --gradient-coding (masks detect the death)")

    from repro_torch.configs import get_config

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    m = args.microbatches
    if args.dry_run:
        n_params, n_act = cfg.param_count()
        print("[train] --dry-run resolved config:")
        print(f"  arch={cfg.name} family={cfg.family} smoke={args.smoke} "
              f"layers={_depth(cfg)} params~{n_params:,.0f} (active~{n_act:,.0f})")
        print(f"  device={args.device or 'cuda'} logical_devices={args.logical_devices} "
              f"steps={args.steps} batch={args.batch} seq={args.seq} lr={args.lr}")
        print(f"  microbatches={m} moment_dtype={args.moment_dtype} "
              f"gradient_coding={args.gradient_coding} "
              f"gc_stragglers={args.gc_stragglers} adaptive_s={args.adaptive_s} "
              f"compress={args.compress}")
        print(f"  straggler: prob={args.straggler_prob} "
              f"slowdown={args.straggler_slowdown} "
              f"persistence={args.straggler_persistence} "
              f"onset={args.straggler_onset}")
        print(f"  ckpt_dir={args.ckpt_dir} ckpt_every={args.ckpt_every} "
              f"kill_at={args.kill_at}")
        return None

    import torch

    from repro_torch import default_device
    from repro_torch.cluster.straggler import MarkovStragglerPolicy
    from repro_torch.core.adaptive import ReplicationController
    from repro_torch.data import make_pipeline
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.runtime import (
        gc_checkpoints,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
        wait_for_saves,
    )
    from repro_torch.runtime.elastic import shrink_mesh
    from repro_torch.runtime.health import HealthMonitor
    from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    dev = default_device(args.device)
    model = build_model(cfg)
    mesh = make_local_mesh(args.logical_devices, args.mesh_model)
    opt_cfg = AdamWConfig(
        lr=warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps),
        moment_dtype=args.moment_dtype,
    )

    def train_cfg(s: int) -> TrainConfig:
        return TrainConfig(
            microbatches=m,
            gradient_coding=args.gradient_coding,
            gc_stragglers=s,
            compression=args.compress,
        )

    tc0 = train_cfg(args.gc_stragglers)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                             opt_cfg, tc0, device=dev)
    print(f"[train] arch={cfg.name} (smoke={args.smoke}) layers={_depth(cfg)} "
          f"grid={mesh.shape} device={dev} "
          f"params~{sum(p.numel() for p in tree_leaves(state['params'])):,}")

    steps_by_level: dict[int, object] = {}

    def train_step(s: int):
        if s not in steps_by_level:
            steps_by_level[s] = make_train_step(model, opt_cfg, train_cfg(s))
        return steps_by_level[s]

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start, state = restore_checkpoint(args.ckpt_dir, state)
        print(f"[train] resumed from step {start}")

    # --- straggler injection + online replication control ------------------
    stream = None
    if args.gradient_coding and (args.straggler_prob > 0 or args.straggler_onset):
        if args.straggler_onset is not None:
            pol = MarkovStragglerPolicy(
                onset=args.straggler_onset, slow_factor=args.straggler_slowdown,
                persistence=args.straggler_persistence)
        else:
            pol = MarkovStragglerPolicy.from_stationary(
                args.straggler_prob, slow_factor=args.straggler_slowdown,
                persistence=args.straggler_persistence)
        stream = pol.stream(m, seed=args.seed)
    controller = ReplicationController(m) if args.adaptive_s else None
    levels = _allowed_levels(args.gradient_coding or "cyclic", m, args.gc_stragglers)
    s_cur = args.gc_stragglers if args.gradient_coding else 0

    pipe = make_pipeline(cfg, seq=args.seq, global_batch=args.batch, seed=args.seed)
    health = HealthMonitor(n_workers=max(m, 1))
    dead_ranks: set[int] = set()
    consec_bad = 0
    skipped = 0
    record = {"steps": [], "events": []}   # per step: (step, loss, ok, s, seconds)
    t0 = time.time()
    tokens_done = 0
    step = start
    metrics = None
    while step < args.steps:
        batch = pipe.batch(step)
        mask = None
        if args.gradient_coding:
            if controller is not None:
                s_cur = controller.replication(levels)
            mult = stream.step() if stream is not None else np.ones(m)
            if dead_ranks:
                dp = mesh.shape.get("data", 1)
                dead_w = [w for w in range(m) if (w % dp) in dead_ranks]
                mult = mult.copy()
                mult[dead_w] = np.inf
            # master waits for the first m - s messages: drop the s
            # realized-slowest (dead workers never arrive at all)
            alive = np.isfinite(mult)
            keep = np.zeros(m, bool)
            order = np.argsort(mult)
            keep[order[: max(m - s_cur, 1)]] = True
            keep &= alive
            mask = torch.as_tensor(keep, dtype=torch.float32).to(dev)
            if controller is not None:
                controller.observe(np.where(alive, mult, np.inf))
        ts = time.time()
        state, metrics = train_step(s_cur if args.gradient_coding else 0)(state, batch, mask)
        ok = float(metrics["ok"]) if "ok" in metrics else 1.0   # waits for the step
        seconds = max(time.time() - ts, 1e-9)
        health.record(0, rows=args.batch * args.seq, seconds=seconds)
        record["steps"].append((step + 1, metrics["loss"], ok, s_cur, seconds))
        if ok < 0.5:
            skipped += 1
            consec_bad += 1
        else:
            consec_bad = 0
            tokens_done += args.batch * args.seq
        if (step + 1) % args.log_every == 0 or step == start:
            print(f"[train] step {step+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} s={s_cur} "
                  f"ok={ok:.0f} tok/s={tokens_done / (time.time() - t0):,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0 and ok >= 0.5:
            save_checkpoint(args.ckpt_dir, step + 1, state, blocking=False)
            gc_checkpoints(args.ckpt_dir, keep=3)

        # --- device-death drill + elastic recovery ------------------------
        if args.kill_at is not None and step + 1 == args.kill_at:
            dp = mesh.shape.get("data", 1)
            if dp > 1:
                dead_ranks.add(dp - 1)
                print(f"[train] drill: DP slice {dp - 1} died at step {step + 1}")
            else:
                print("[train] drill skipped: grid has a single DP slice")
        if dead_ranks and consec_bad >= args.detect_steps:
            print(f"[train] {consec_bad} unrecoverable steps -> elastic recovery")
            wait_for_saves()
            dp = mesh.shape.get("data", 1)
            dead_dev = {int(d) for i, row in enumerate(mesh.devices)
                        for d in np.asarray(row).flat if i in dead_ranks}
            mesh = shrink_mesh(mesh, dead_dev)
            ck_step, state = restore_checkpoint(args.ckpt_dir, state)
            print(f"[train] re-meshed {dp}->{mesh.shape.get('data', 1)} DP "
                  f"slices; resumed from checkpoint step {ck_step}")
            record["events"].append({"at": step + 1, "dp_before": dp,
                                     "dp_after": mesh.shape.get("data", 1),
                                     "restored_step": ck_step})
            dead_ranks.clear()
            consec_bad = 0
            step = ck_step
            continue
        step += 1
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state)
        wait_for_saves()
    final = float(metrics["loss"]) if metrics is not None else float("nan")
    print(f"[train] done in {time.time() - t0:.1f}s; skipped={skipped}; "
          f"final loss={final:.4f}")
    record["steps"] = [(s, float(loss), ok, lvl, sec) for s, loss, ok, lvl, sec in record["steps"]]
    record.update(skipped=skipped, final_loss=final, state=state, mesh=mesh.shape,
                  tokens=tokens_done, seconds=time.time() - t0)
    return record


if __name__ == "__main__":
    main()
