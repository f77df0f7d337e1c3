"""The one traffic generator: a cell's traffic file in, its requests out.

A traffic file (``traffic/<mix>.json``) holds parameters only: the loop
(``open`` with an arrival process and rate, or ``closed`` with a number of
clients), the prompt and output length distributions, and the engine's
shape.  The arrival arithmetic is a copy of ``repro_torch/serve/loadgen.py``
(Poisson gaps; the two-state Markov-modulated bursts of ``bursty_trace``;
the geometric token draw of ``_draw_tokens``), with lognormal and uniform
length draws added.

Every seed gets the same work in another order: lengths and gaps are the
quantiles of their distribution at N evenly spaced probabilities, and the
seed only permutes them (and draws the prompts' token ids).  So two seeds
offer the same tokens at the same mean rate, and runs differ by order
alone.  A Markov-modulated process has no such quantile grid; its draws
follow the seed, as ``bursty_trace``'s do.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent
_NORMAL = NormalDist()


@dataclass(frozen=True)
class Traffic:
    """One traffic mix, drawn for one seed."""

    name: str
    loop: str                    # "open" | "closed"
    params: dict                 # the traffic file, smoke overrides applied
    prompt_len: np.ndarray       # [N] int64
    out_len: np.ndarray          # [N] int64 tokens to serve, the prefill's first included
    t_arrival: np.ndarray | None  # [N] float64 seconds from the window's start (open loop)
    clients: int                 # closed loop: clients; open loop: 0

    @property
    def n(self) -> int:
        return len(self.prompt_len)


def _merge(p: dict, over: dict) -> dict:
    return {**p, **{k: ({**p[k], **v} if isinstance(v, dict) and isinstance(p.get(k), dict)
                        else v) for k, v in over.items()}}


def load(mix: str, smoke: bool = False, overrides: dict | None = None) -> dict:
    """The traffic file of ``mix``, with its ``smoke`` overrides applied
    when ``smoke`` (the CPU tests' sizes), then ``overrides`` (a sweep's)."""
    p = json.loads((HERE / f"{mix}.json").read_text())
    if smoke:
        p = _merge(p, p.get("smoke", {}))
    return _merge(p, overrides or {})


def seeded_rng(seed: int, stream: int) -> np.random.Generator:
    """Stream ``stream`` of the run's seed (any whole number up to 64 bits)."""
    s = int(seed)
    return np.random.default_rng([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, stream])


def _norm_ppf(u: np.ndarray) -> np.ndarray:
    """The standard normal quantile of each probability in ``u``."""
    return np.array([_NORMAL.inv_cdf(float(x)) for x in np.ravel(u)]).reshape(np.shape(u))


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _quantiles(spec: dict, n: int) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        v = np.rint(np.exp(math.log(spec["median"]) + spec["sigma"] * _norm_ppf(_grid(n))))
    elif spec["dist"] == "uniform":
        v = np.floor(lo + (hi - lo + 1) * _grid(n))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(v, lo, hi).astype(np.int64)


def lengths(spec: dict, n: int, rng: np.random.Generator, block: int) -> np.ndarray:
    """N lengths of a distribution spec: ``lognormal`` (median, sigma) or
    ``uniform`` (min, max, inclusive) as the quantiles at a grid of
    ``block`` points, each block of ``block`` requests a permutation of
    them (so every prefix of whole blocks holds the same lengths); or
    ``geometric`` (mean: ``loadgen._draw_tokens``'s draw, which follows the
    seed).  Each clipped to [min, max]."""
    if spec["dist"] == "geometric":
        v = rng.geometric(p=min(1.0, 1.0 / max(spec["mean"], 1.0)), size=n)
        return np.clip(v, int(spec["min"]), int(spec["max"])).astype(np.int64)
    out = [rng.permutation(_quantiles(spec, min(block, n - i))) for i in range(0, n, block)]
    return np.concatenate(out)


def arrivals(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """N arrival times from 0: ``poisson`` (gaps at the exponential's
    quantiles, permuted) or ``bursty`` (``loadgen.bursty_trace``'s
    two-state process at the same mean rate)."""
    rate = float(spec["rate_per_s"])
    if spec["kind"] == "poisson":
        gaps = rng.permutation(-np.log1p(-_grid(n)) / rate)
        return np.cumsum(gaps) - gaps[0]
    if spec["kind"] == "bursty":
        bf, duty, soj = spec.get("burst_factor", 6.0), spec.get("duty", 0.2), \
            spec.get("mean_sojourn_s", 10.0)
        rate_off = rate / (duty * bf + (1.0 - duty))
        rate_on = bf * rate_off
        t = np.empty(n)
        now, on, i = 0.0, False, 0
        seg_end = rng.exponential(soj * (1.0 - duty))
        while i < n:
            gap = rng.exponential(1.0 / (rate_on if on else rate_off))
            if now + gap < seg_end:
                now += gap
                t[i] = now
                i += 1
            else:
                now, on = seg_end, not on
                seg_end = now + rng.exponential(soj * (duty if on else 1.0 - duty))
        return t - t[0]
    raise ValueError(f"unknown arrival process {spec['kind']!r}")


def draw(mix: str, seed: int, seconds: float, smoke: bool = False,
         overrides: dict | None = None) -> Traffic:
    """The cell's requests for one run of ``seconds``: an open loop gets
    rate x seconds arrivals (at least one); a closed loop a pool of
    ``pool_per_s`` x seconds requests, taken in order by whichever
    client is free."""
    p = load(mix, smoke, overrides)
    loop = p["loop"]
    if loop == "open":
        n = max(1, int(round(p["arrivals"]["rate_per_s"] * seconds)))
    elif loop == "closed":
        n = max(p["clients"], int(math.ceil(p["pool_per_s"] * seconds)))
    else:
        raise ValueError(f"unknown loop {loop!r}")
    rng = seeded_rng(seed, 1)
    block = int(p.get("block", 32))
    prompt = lengths(p["prompt"], n, rng, block)
    out = lengths(p["output"], n, rng, block)
    t = arrivals(p["arrivals"], n, rng) if loop == "open" else None
    return Traffic(mix, loop, p, prompt, out, t, p.get("clients", 0) if loop == "closed" else 0)


def token_ids(seed: int, prompt_len: np.ndarray, vocab: int) -> list[np.ndarray]:
    """Every prompt's token ids, uniform over the vocabulary, from the seed."""
    rng = seeded_rng(seed, 2)
    flat = rng.integers(0, vocab, int(prompt_len.sum()), dtype=np.int64)
    return np.split(flat, np.cumsum(prompt_len)[:-1])
