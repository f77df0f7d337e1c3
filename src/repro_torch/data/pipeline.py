"""Deterministic synthetic LM data pipeline.

Copied from ``repro.data.pipeline`` (numpy only), imports pointed at
``repro_torch``; the tests hold its batches ``np.array_equal`` to the
reference's on the same seed.  Batches are numpy: the train step moves
them to its device.

Design goals of a production input pipeline, scaled to this repo:

  * **checkpointable** — a batch is a pure function of (seed, step); resuming
    from step k replays the exact stream, so checkpoint/restart never skips
    or repeats data;
  * **sharded** — per-host slicing by (host_id, n_hosts) mirrors how a real
    multi-host pod feeds per-host shards of the global batch;
  * **learnable** — tokens follow an order-2 affine Markov chain with noise,
    so example runs show a real loss curve (not memorized noise);
  * **family-aware** — vlm batches carry stub patch embeddings, encdec
    batches carry stub frame embeddings (the assigned modality frontends
    are stubs per the task).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.utils.prng import derive, rng as _rng

__all__ = ["SyntheticLM", "make_pipeline"]


@dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    seq: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_hosts != 0:
            raise ValueError("global batch must divide across hosts")
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Local shard of the global batch for ``step`` (deterministic)."""
        b, s, v = self.local_batch, self.seq, self.cfg.vocab
        g = _rng(derive(self.seed, "data", step, self.host_id))
        # order-2 affine Markov chain: x_t = (a*x_{t-1} + b*x_{t-2} + c + eps) % V
        a, bb, c = 31, 17, 7
        toks = np.zeros((b, s + 1), dtype=np.int64)
        toks[:, 0] = g.integers(0, v, size=b)
        toks[:, 1] = g.integers(0, v, size=b)
        noise = (g.random((b, s + 1)) < 0.05) * g.integers(0, v, size=(b, s + 1))
        for t in range(2, s + 1):
            toks[:, t] = (a * toks[:, t - 1] + bb * toks[:, t - 2] + c + noise[:, t]) % v
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.family == "vlm":
            out["img_embed"] = (
                g.standard_normal((b, self.cfg.img_tokens, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
        if self.cfg.family == "encdec":
            out["frames"] = (
                g.standard_normal((b, s, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
        return out

    def batches(self, start_step: int, n: int):
        for i in range(n):
            yield self.batch(start_step + i)


def make_pipeline(
    cfg: ModelConfig, seq: int, global_batch: int, seed: int = 0, **kw
) -> SyntheticLM:
    return SyntheticLM(cfg=cfg, seq=seq, global_batch=global_batch, seed=seed, **kw)
