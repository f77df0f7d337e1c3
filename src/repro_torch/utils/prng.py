"""Deterministic PRNG helpers shared across the framework.

Everything that samples (load scenarios, LT degree tables, synthetic data,
simulated completion times) threads an explicit seed through numpy's
``Generator`` or ``jax.random`` keys so that every experiment in
EXPERIMENTS.md is exactly reproducible.

Copied from ``repro.utils.prng``, imports pointed at ``repro_torch``:
the port never imports ``repro``, whose package import pulls in jax.
The tests hold the copy bit-equal to the reference on the same seeds.
"""
from __future__ import annotations

import numpy as np


def rng(seed: int) -> np.random.Generator:
    """A process-independent numpy Generator (PCG64)."""
    return np.random.Generator(np.random.PCG64(seed))


# --------------------------------------------------------------------------
# Fast per-seed generators for Monte-Carlo loops
# --------------------------------------------------------------------------
# ``np.random.PCG64(seed)`` costs ~50 us/call (allocation + lock + seeding
# machinery), which dominates vectorized Monte-Carlo sweeps that need one
# deterministic generator per trial.  PCG64's seeding is two LCG steps over
# the four SeedSequence words (numpy pcg64.c: pcg_setseq_128_srandom_r), so
# we compute the post-seeding state directly and write it into ONE reusable
# bit generator — bit-identical streams at ~2x the throughput.  A self-check
# against the reference constructor runs once; any mismatch (e.g. a future
# numpy changing its seeding path) falls back to ``rng`` transparently.
_PCG_MULT = (2549297995355413924 << 64) | 4865540595714422341
_MASK128 = (1 << 128) - 1


def _pcg64_seeded_state(seed: int) -> tuple[int, int]:
    w = np.random.SeedSequence(seed).generate_state(4, np.uint64)
    initstate = (int(w[0]) << 64) | int(w[1])
    initseq = (int(w[2]) << 64) | int(w[3])
    inc = ((initseq << 1) | 1) & _MASK128
    state = ((inc + initstate) * _PCG_MULT + inc) & _MASK128
    return state, inc


# SeedSequence's entropy-mixing hash (O'Neill seed_seq, 32-bit arithmetic;
# stream-stability is part of numpy's compatibility policy), vectorized
# across seeds: one [T]-lane uint32 pipeline replaces T sequential
# ``SeedSequence(seed).generate_state(4)`` calls.  The evolving hash
# constants are call-order-dependent but seed-independent, so they stay
# scalars while the data lanes vectorize.
_INIT_A = np.uint32(0x43B0D7E5)
_MULT_A = np.uint32(0x931E8875)
_INIT_B = np.uint32(0x8B51F9DD)
_MULT_B = np.uint32(0x58F38DED)
_MIX_L = np.uint32(0xCA01F9DD)
_MIX_R = np.uint32(0x4973F715)


def _seedseq_words_batch(seeds: np.ndarray) -> np.ndarray:
    """[T] uint32-range seeds -> [T, 4] uint64 == SeedSequence(s).generate_state(4)."""
    with np.errstate(over="ignore"):
        hc = [_INIT_A]  # evolving hash constant (shared across lanes)

        def hashmix(v):
            v = v ^ hc[0]
            hc[0] = hc[0] * _MULT_A
            v = v * hc[0]
            return v ^ (v >> np.uint32(16))

        def mix(x, y):
            r = x * _MIX_L - y * _MIX_R
            return r ^ (r >> np.uint32(16))

        ent = np.asarray(seeds, dtype=np.uint32)
        zeros = np.zeros_like(ent)
        pool = [hashmix(ent)] + [hashmix(zeros) for _ in range(3)]
        for i_src in range(4):
            for i_dst in range(4):
                if i_src != i_dst:  # hashmix per (src, dst): hc advances each
                    pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src]))
        hc[0] = _INIT_B
        out = np.empty((ent.shape[0], 8), dtype=np.uint32)
        for i in range(8):
            v = pool[i % 4] ^ hc[0]
            hc[0] = hc[0] * _MULT_B
            v = v * hc[0]
            out[:, i] = v ^ (v >> np.uint32(16))
        return out.view(np.uint64)


class _ScratchRng:
    def __init__(self):
        self._bg = np.random.PCG64()
        self._tmpl = self._bg.state
        self._ok = bool(
            np.array_equal(
                self._seeded(987654321).standard_normal(4),
                rng(987654321).standard_normal(4),
            )
        )

    def _seeded(self, seed: int) -> np.random.Generator:
        state, inc = _pcg64_seeded_state(seed)
        return self._set(state, inc)

    def _set(self, state: int, inc: int) -> np.random.Generator:
        self._tmpl["state"] = {"state": state, "inc": inc}
        self._tmpl["has_uint32"] = 0
        self._tmpl["uinteger"] = 0
        self._bg.state = self._tmpl
        return np.random.Generator(self._bg)

    def __call__(self, seed: int) -> np.random.Generator:
        if not self._ok:  # pragma: no cover - numpy-version escape hatch
            return rng(seed)
        return self._seeded(seed)

    def from_words(self, w: np.ndarray) -> np.random.Generator:
        """Generator from precomputed SeedSequence words [4] uint64."""
        initstate = (int(w[0]) << 64) | int(w[1])
        initseq = (int(w[2]) << 64) | int(w[3])
        inc = ((initseq << 1) | 1) & _MASK128
        state = ((inc + initstate) * _PCG_MULT + inc) & _MASK128
        return self._set(state, inc)


_scratch = None
_batch_ok = None


def rng_scratch(seed: int) -> np.random.Generator:
    """Like ``rng`` but reuses one bit generator: streams are bit-identical,
    construction is ~2x cheaper.  The returned Generator is INVALIDATED by
    the next ``rng_scratch`` call — draw from it immediately, never store it
    (made for tight one-generator-per-trial Monte-Carlo loops)."""
    global _scratch
    if _scratch is None:
        _scratch = _ScratchRng()
    return _scratch(seed)


def rng_scratch_iter(seeds: np.ndarray):
    """Yield one bit-identical Generator per seed, batch-seeded.

    The SeedSequence hash for ALL seeds runs as one vectorized uint32
    pipeline, then each trial costs only a PCG64 state install.  Same
    invalidation contract as ``rng_scratch``: consume each generator before
    advancing the iterator.  Self-checks against ``rng`` once per process
    and falls back to the reference constructor on any mismatch (or for
    seeds outside uint32 range, whose entropy spans multiple words).
    """
    global _scratch, _batch_ok
    if _scratch is None:
        _scratch = _ScratchRng()
    seeds = np.asarray(seeds)
    if _batch_ok is None:
        probe = np.array([0, 1, 987654321, 2**32 - 1], dtype=np.uint64)
        want = np.stack(
            [np.random.SeedSequence(int(s)).generate_state(4, np.uint64) for s in probe]
        )
        _batch_ok = bool(np.array_equal(_seedseq_words_batch(probe), want))
    in_range = (
        np.issubdtype(seeds.dtype, np.integer)
        and seeds.size > 0
        and int(seeds.min()) >= 0
        and int(seeds.max()) < 2**32
    )
    if _scratch._ok and _batch_ok and in_range:
        words = _seedseq_words_batch(seeds)
        for t in range(seeds.shape[0]):
            yield _scratch.from_words(words[t])
    else:  # pragma: no cover - escape hatch for exotic seeds / numpy drift
        for s in seeds:
            yield rng(int(s))


def derive(seed: int, *tags: int | str) -> int:
    """Derive a child seed from (seed, tags) — stable across runs/platforms."""
    h = int(seed)
    for t in tags:
        if isinstance(t, str):
            t = sum((i + 1) * b for i, b in enumerate(t.encode()))
        h = (h * 6364136223846793005 + int(t) * 2 + 1) % (1 << 64)
    return int(h % (2**31 - 1))
