"""Reproduce the paper's EC2 Experiment 1 + 2 (Figs 8, 10) on the PyTorch port.

    PYTHONPATH=src python examples/ec2_repro_torch.py [--scale 40] [--trials 8]
        [--backend model|thread|process] [--device cuda|cpu]
        [--encode-mode device|none|off|cuda|auto]

The same experiment grid as ``examples/ec2_repro.py``, run through
``repro_torch.cluster``.  The master encodes each coded task's rows Â with
``--encode-mode`` (default 'device': one encode kernel launch a task on
``--device``, the card unless the CPU is named; 'none' is the host's numpy
encode).  The task runs in model time, so the printed tables do not depend
on where Â was encoded.

Instance mixes and (mu, alpha) come from the paper's Table 1; matrix sizes
are scaled down so the grid runs in minutes.  Expected qualitative results
(the paper's claims):
  * with 20% unexpected stragglers BPCC beats Uniform/Load-Balanced/HCMM
    in every scenario;
  * sweeping straggler probability 0 -> 0.6, uncoded schemes win only at 0;
    HCMM degrades below uncoded at high straggler rates; BPCC stays best.
"""
import argparse

import numpy as np

from repro_torch.cluster import ClusterEmulator, StragglerPolicy, TaskSpec, ec2_scenario
from repro_torch.utils.prng import rng as _rng

SCHEMES = ["uniform", "load_balanced", "hcmm", "bpcc"]
ENCODE_MODES = ["device", "none", "off", "cuda", "auto"]


def main(argv: list[str] | None = None) -> list[dict]:
    """Print both experiments' tables; return one record a task: the
    experiment, its scenario or straggler probability, the scheme, ``ok``,
    ``t_complete``, the rows assigned, A's shape and the master's encode
    (``ClusterEmulator.last_encode``: its plan, rows and seconds; None where
    none ran)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=40, help="divide paper r by this")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--backend", default="model",
                    choices=["model", "thread", "process"],
                    help="model = deterministic emulator (model seconds); "
                         "thread/process = wall-clock execution, paced to the "
                         "model schedule so straggler cells reproduce")
    ap.add_argument("--device", default=None,
                    help="where the master encodes Â (default: the card)")
    ap.add_argument("--encode-mode", default="device", choices=ENCODE_MODES,
                    help="'none' is the host encode")
    args = ap.parse_args(argv)
    encode_mode = None if args.encode_mode == "none" else args.encode_mode
    records: list[dict] = []

    def run(experiment: int, case, em: ClusterEmulator, a, x, scheme: str) -> float:
        spec = TaskSpec(scheme=scheme, code="lt", backend=args.backend,
                        encode_mode=encode_mode)
        res = em.run_task(a, x, spec)
        records.append({"experiment": experiment, "case": case, "scheme": scheme,
                        "ok": res.ok, "t_complete": res.t_complete,
                        "rows_assigned": res.rows_assigned, "a_shape": a.shape,
                        "encode": em.last_encode})
        return res.t_complete

    print("=== Experiment 1 (Fig 8): 20% stragglers, scenarios 1-4 ===")
    for s in [1, 2, 3, 4]:
        r, workers = ec2_scenario(s)
        r //= args.scale
        g = _rng(s)
        a = g.standard_normal((r, args.m)).astype(np.float32)
        x = g.standard_normal(args.m).astype(np.float32)
        line = [f"scenario {s} (r={r}, N={len(workers)}):"]
        means = {}
        for scheme in SCHEMES:
            em = ClusterEmulator(workers, time_scale=1.0,
                                 straggler=StragglerPolicy(prob=0.2), seed=s,
                                 device=args.device)
            ts = [run(1, s, em, a, x, scheme) for _ in range(args.trials)]
            means[scheme] = np.mean(ts)
            line.append(f"{scheme}={means[scheme]:.3f}s")
        best = min(means, key=means.get)
        line.append(f"[best: {best}]")
        print("  " + "  ".join(line))

    print("\n=== Experiment 2 (Fig 10): straggler sweep, scenario 4 ===")
    r, workers = ec2_scenario(4)
    r //= args.scale
    g = _rng(99)
    a = g.standard_normal((r, args.m)).astype(np.float32)
    x = g.standard_normal(args.m).astype(np.float32)
    for prob in [0.0, 0.2, 0.4, 0.6]:
        line = [f"p_straggle={prob:.1f}:"]
        for scheme in SCHEMES:
            em = ClusterEmulator(workers, time_scale=1.0,
                                 straggler=StragglerPolicy(prob=prob), seed=5,
                                 device=args.device)
            ts = [run(2, prob, em, a, x, scheme) for _ in range(args.trials)]
            line.append(f"{scheme}={np.mean(ts):.3f}s")
        print("  " + "  ".join(line))
    return records


if __name__ == "__main__":
    main()
