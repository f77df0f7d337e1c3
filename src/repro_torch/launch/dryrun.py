"""Dry run: reckon every (arch x shape x mesh) cell on the meta device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out reports/bench/cuda/dryrun.json

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for the 16x16 (256-chip) and 2x16x16 (512-chip) TPU v5e meshes and
reads memory, FLOPs and collectives from the compiled program.  The port
has no compiler to ask: it builds each cell's step (the train step, the
prefill or the decode step, as the reference does) over ``meta`` tensors
of the full configuration, runs it once under
``repro_torch.utils.hlo.analyze_ops`` (FLOPs by dtype and bytes, op by op),
and reckons under the sharding policy's specs
(``repro_torch.sharding.policy``) on a logical mesh
(``repro_torch.launch.mesh``):

  * ``memory``: each device's argument and output bytes from the specs
    (``device_bytes``); ``temp_size_in_bytes`` is None (no compiler);
  * ``cost``: the step's global FLOPs and bytes, and each device's as
    global / chips — which ignores work that the mesh replicates;
  * ``roofline``: the three-term roofline of a device's share with the
    H100's constants (``HW_H100``), the compute term by dtype; no
    collectives are reckoned, so ``collective_s`` is None;
  * ``hints``: the policy's activation specs.

Every number is reckoned, not measured.  The program is counted once per
(arch, shape, coded, overrides) and reckoned under both meshes.  Nothing
here touches a device: a run needs no card, and imports no jax.  A cell's
function also runs on real tensors: ``build_cell(..., device="cuda")``
makes its arguments seeded on the card (``chip_smoke.py``'s dryrun phase).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.configs.shapes import Workload
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.policy import Spec, device_bytes, make_policy
from repro_torch.train.loop import TrainConfig, init_train_state, make_train_step
from repro_torch.utils.hlo import HW_H100, Roofline, analyze_ops, roofline
from repro_torch.utils.tree import tree_map

__all__ = ["train_plan", "model_flops", "build_cell", "count_cell", "reckon", "run_cells",
           "run_cell", "main", "DEFAULT_OUT", "BASIS"]

DEFAULT_OUT = str(Path(__file__).resolve().parents[3] / "reports" / "bench" / "cuda"
                  / "dryrun.json")
BASIS = ("reckoned on the meta device (op counts of the plain program, the sharding "
         "policy's specs, the H100's data-sheet rates), not measured")


# --------------------------------------------------------------------------
# per-arch training plan (what a launcher config file would pin)
# --------------------------------------------------------------------------
def train_plan(cfg: ModelConfig) -> dict:
    n, _ = cfg.param_count()
    if n >= 50e9:
        # int8 moments + per-sequence microbatches + sequence-sharded
        # activations: required to fit 16 GB/chip on the reference's mesh
        return {"moment_dtype": "int8", "microbatches": 16, "seq_shard_act": True}
    if n >= 8e9:
        return {"moment_dtype": "float32", "microbatches": 4, "seq_shard_act": False}
    return {"moment_dtype": "float32", "microbatches": 1, "seq_shard_act": False}


# --------------------------------------------------------------------------
# analytic useful-FLOPs (global): 6·N·D train / 2·N·D forward (+ attn reads)
# --------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, wl: Workload) -> float:
    _, n_act = cfg.param_count()
    t = wl.batch * wl.seq
    hd = cfg.resolved_head_dim
    if wl.kind == "train":
        attn = 12 * cfg.n_layers * wl.batch * wl.seq**2 * cfg.n_heads * hd
        return 6.0 * n_act * t + (attn if cfg.n_heads else 0)
    if wl.kind == "prefill":
        attn = 4 * cfg.n_layers * wl.batch * wl.seq**2 * cfg.n_heads * hd
        return 2.0 * n_act * t + (attn if cfg.n_heads else 0)
    # decode: one token per sequence + KV attention over the cache
    attn = 4 * cfg.n_layers * wl.batch * wl.seq * cfg.n_heads * hd
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.attn_every
        attn = 4 * n_apps * wl.batch * wl.seq * cfg.n_heads * hd
    if cfg.family == "ssm":
        attn = 0
    return 2.0 * n_act * wl.batch + attn


# --------------------------------------------------------------------------
# cell construction
# --------------------------------------------------------------------------
_PLAN_KEYS = {"microbatches", "moment_dtype", "seq_shard_act", "shard_grad_accum"}


def _resolve(cfg: ModelConfig, coded: bool, overrides: dict | None) -> tuple[ModelConfig, dict]:
    if coded:
        cfg = cfg.scaled(coded=True)
    plan_over = {}
    if overrides:
        cfg_over = {k: v for k, v in overrides.items() if k not in _PLAN_KEYS}
        plan_over = {k: v for k, v in overrides.items() if k in _PLAN_KEYS}
        if cfg_over:
            cfg = cfg.scaled(**cfg_over)
    return cfg, {**train_plan(cfg), **plan_over}


def _batch(model, kind: str, wl: Workload, device, generator) -> dict:
    """The step's inputs: meta stand-ins, or seeded tensors of the same
    shapes and dtypes on a real device."""
    specs = model.input_specs(kind, wl.batch, wl.seq)
    if torch.device(device).type == "meta":
        return specs
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            out[k] = torch.randn(s.shape, generator=generator, device=device).to(s.dtype)
        else:
            out[k] = torch.randint(0, model.cfg.vocab, s.shape, generator=generator,
                                   device=device, dtype=s.dtype)
    return out


def build_cell(cfg: ModelConfig, wl: Workload, mesh, *, coded: bool = False,
               overrides: dict | None = None, device="meta",
               generator: torch.Generator | None = None):
    """Returns (fn, example_args, meta).

    ``example_args`` are ``meta`` tensors (``device="meta"``) or, on a real
    device, seeded params (``Model.init``), zero caches and optimizer
    state, and random tokens and embeddings of the same shapes and dtypes.
    ``meta`` holds the policy's specs of the arguments (``arg_specs``, one
    tree an argument), ``out_specs(outputs)`` for the step's outputs, the
    activation ``hints``, the train ``plan`` and the resolved ``cfg``.

    ``overrides``: ModelConfig fields (onehot_ce, pad_heads, ...) or
    train-plan fields (microbatches, moment_dtype, seq_shard_act).  The
    reference's ``grad_shardings`` needs a device mesh: the port's step
    takes none.
    """
    cfg, plan = _resolve(cfg, coded, overrides)
    model = build_model(cfg)
    small_batch = wl.batch < mesh.shape.get("data", 1)
    # decode cells whose KV cache is sequence-sharded (KV heads don't divide
    # TP) also contraction-shard the attn projections — see ShardingPolicy
    seq_sharded_cache = (
        wl.kind == "decode"
        and cfg.n_kv_heads > 0
        and cfg.n_kv_heads % mesh.shape.get("model", 1) != 0
    )
    policy = make_policy(mesh, cfg, fsdp=True, shard_cache_seq=small_batch,
                         qkv_contraction=seq_sharded_cache)
    hints = policy.hints()
    if wl.kind == "train" and plan["seq_shard_act"]:
        hints["act_bsd"] = Spec(policy.dp_axes, "model", None)
    meta = {"hints": hints, "plan": plan, "cfg": cfg, "policy": policy}
    if torch.device(device).type != "meta" and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    if wl.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=plan["moment_dtype"])
        step = make_train_step(model, opt_cfg, TrainConfig(microbatches=plan["microbatches"]))
        state = init_train_state(model, generator, opt_cfg, device=device)
        batch = _batch(model, "train", wl, device, generator)
        meta["arg_specs"] = (policy.state_specs(state), policy.batch_specs(batch))
        meta["out_specs"] = lambda out: (policy.state_specs(out[0]),
                                         tree_map(lambda x: Spec(*(None,) * x.dim()), out[1]))
        return (lambda s, b: step(s, b)), (state, batch), meta

    params = model.init(generator, device)
    pspecs = policy.param_specs(params)

    def serve_out(out):
        logits, cache = out
        return policy.batch_spec("logits", tuple(logits.shape)), policy.cache_specs(cache)

    meta["out_specs"] = serve_out
    if wl.kind == "prefill":
        batch = _batch(model, "prefill", wl, device, generator)
        meta["arg_specs"] = (pspecs, policy.batch_specs(batch))

        def prefill(p, b):
            with torch.no_grad():
                return model.prefill(p, b)

        return prefill, (params, batch), meta

    if wl.kind == "decode":
        cache = model.init_cache(wl.batch, wl.seq, device=device)
        tokens = _batch(model, "decode", wl, device, generator)["tokens"]
        tok_spec = policy.fit((policy.dp_axes if not small_batch else None,), (wl.batch,))
        meta["arg_specs"] = (pspecs, policy.cache_specs(cache), tok_spec)

        def decode(p, c, t):
            with torch.no_grad():
                return model.decode_step(p, c, t)

        return decode, (params, cache, tokens), meta

    raise ValueError(wl.kind)


# --------------------------------------------------------------------------
def count_cell(cfg: ModelConfig, wl: Workload, coded: bool = False,
               overrides: dict | None = None) -> dict:
    """The cell's program counted once on meta tensors (the mesh does not
    change the program): {"costs": OpCosts, "args": the meta arguments,
    "count_s": seconds}."""
    t0 = time.perf_counter()
    fn, args, _ = build_cell(cfg, wl, make_production_mesh(), coded=coded, overrides=overrides)
    costs = analyze_ops(fn, *args)
    return {"costs": costs, "args": args, "count_s": time.perf_counter() - t0}


def reckon(cfg: ModelConfig, wl: Workload, mesh, coded: bool = False,
           overrides: dict | None = None, counted: dict | None = None) -> tuple[dict, Roofline]:
    """The cell's numbers under ``mesh`` as ``run_cell`` reports them
    (memory, cost, roofline with HW_H100, hints), and the ``Roofline``;
    ``counted`` is the cell's ``count_cell`` (counted here when None)."""
    if counted is None:
        counted = count_cell(cfg, wl, coded, overrides)
    costs, args = counted["costs"], counted["args"]
    _, _, meta = build_cell(cfg, wl, mesh, coded=coded, overrides=overrides)
    chips = mesh.size
    memory = {
        "argument_size_in_bytes": sum(device_bytes(a, s, mesh)
                                      for a, s in zip(args, meta["arg_specs"])),
        "output_size_in_bytes": device_bytes(costs.outputs, meta["out_specs"](costs.outputs),
                                             mesh),
        "temp_size_in_bytes": None,
    }
    rl = roofline(costs.flops / chips, costs.hbm_bytes / chips, None,
                  model_flops=model_flops(meta["cfg"], wl) / chips, hw=HW_H100,
                  flops_by_dtype={d: f / chips for d, f in costs.flops_by_dtype.items()})
    return {
        "chips": chips,
        "count_s": counted["count_s"],
        "memory": memory,
        "cost": {
            "flops": costs.flops, "flops_by_dtype": dict(costs.flops_by_dtype),
            "hbm_bytes": costs.hbm_bytes, "ops": costs.ops,
            "per_device_flops": costs.flops / chips,
            "per_device_hbm_bytes": costs.hbm_bytes / chips,
            "per_device": "global / chips: work the mesh replicates is ignored",
        },
        "roofline": rl.as_dict(),
        "hw": HW_H100.name,
        "hints": {k: list(v) for k, v in meta["hints"].items()},
        "train_plan": meta["plan"] if wl.kind == "train" else None,
        "basis": BASIS,
    }, rl


def _error_row(arch: str, shape: str, multi_pod: bool, coded: bool, e: Exception) -> dict:
    tag = "2pod" if multi_pod else "1pod"
    print(f"[dryrun] {arch} x {shape} x {tag}: FAIL {type(e).__name__}: {e}")
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "coded": coded, "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def run_cells(arch: str, shape: str, pods, coded: bool = False,
              overrides: dict | None = None) -> list[dict]:
    """One row for each mesh in ``pods`` (False: 16 x 16, True: 2 x 16 x 16),
    the program counted once for all of them.  A failure is an ``error``
    row with its traceback, not an exception."""
    cfg = get_config(arch)
    wl = SHAPES[shape]
    ok, why = applicable(cfg, shape)
    if not ok:
        return [{"arch": arch, "shape": shape, "multi_pod": mp,
                 "status": "skipped", "reason": why} for mp in pods]
    try:
        counted = count_cell(cfg, wl, coded, overrides)
    except Exception as e:  # noqa: BLE001 — report failures as data
        return [_error_row(arch, shape, mp, coded, e) for mp in pods]
    rows = []
    for mp in pods:
        tag = "2pod" if mp else "1pod"
        try:
            res, rl = reckon(cfg, wl, make_production_mesh(multi_pod=mp), coded=coded,
                             overrides=overrides, counted=counted)
        except Exception as e:  # noqa: BLE001 — report failures as data
            rows.append(_error_row(arch, shape, mp, coded, e))
            continue
        print(f"[dryrun] {arch} x {shape} x {tag}{' coded' if coded else ''}: OK "
              f"count={res['count_s']:.1f}s dominant={rl.dominant} "
              f"bound={rl.bound_s * 1e3:.2f}ms mfu_bound={rl.mfu_bound:.2%}")
        print(f"  memory: {res['memory']}")
        print(f"  ops: flops={res['cost']['flops']:.3e} bytes={res['cost']['hbm_bytes']:.3e} "
              f"(global; per device / {res['chips']})")
        rows.append({"arch": arch, "shape": shape, "multi_pod": mp, "coded": coded,
                     "status": "ok", **res})
    return rows


def run_cell(arch: str, shape: str, multi_pod: bool, coded: bool = False,
             overrides: dict | None = None) -> dict:
    return run_cells(arch, shape, (multi_pod,), coded, overrides)[0]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--coded", action="store_true",
                    help="enable the BPCC coded serving head")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"write the JSON report here (default {DEFAULT_OUT}; '' writes none)")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already ok/skipped in --out")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="perf knob: key=value (int/bool/str inferred); "
                         "repeatable — e.g. --set onehot_ce=1 --set microbatches=4")
    ap.add_argument("--dry-run", action="store_true",
                    help="list the resolved (arch x shape x mesh) cells with "
                         "applicability and the per-arch train plan, without "
                         "counting anything")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.overrides:
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            overrides[k] = v.lower() == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v
    if overrides:
        print(f"[dryrun] overrides: {overrides}")

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]

    if args.dry_run:
        # resolved-plan listing, no device work: the config-validation idiom
        n_cells = 0
        for arch in archs:
            cfg = get_config(arch)
            plan = train_plan(cfg)
            n, _ = cfg.param_count()
            print(f"[dryrun] --dry-run {arch}: family={cfg.family} "
                  f"params~{n:,.0f} train_plan={plan}")
            for shape in shapes:
                ok, why = applicable(cfg, shape)
                for mp in pods:
                    tag = "2pod" if mp else "1pod"
                    status = "ok" if ok else f"skip ({why})"
                    print(f"    x {shape} x {tag}"
                          f"{' coded' if args.coded else ''}: {status}")
                    n_cells += ok
        print(f"[dryrun] --dry-run: {n_cells} compilable cells resolved; "
              f"nothing compiled")
        return

    done: set = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                if r["status"] in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["multi_pod"],
                              r.get("coded", False)))
        print(f"[dryrun] resume: {len(done)} cells already complete")

    key = lambda r: (r["arch"], r["shape"], r["multi_pod"], r.get("coded", False))  # noqa: E731

    def persist(results):
        if not args.out:
            return
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        merged = {key(r): r for r in existing}
        for r in results:
            merged[key(r)] = r
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(list(merged.values()), f, indent=1)
        os.replace(tmp, args.out)

    t0 = time.perf_counter()
    results = []
    for arch in archs:
        for shape in shapes:
            todo = [mp for mp in pods if (arch, shape, mp, args.coded) not in done]
            if todo:
                results += run_cells(arch, shape, todo, coded=args.coded,
                                     overrides=overrides or None)
                persist(results)  # incremental: survive kills/restarts
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"in {time.perf_counter() - t0:.1f}s")
    if args.out:
        print(f"[dryrun] wrote {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
