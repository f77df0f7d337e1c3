"""Batched serving engine with continuous batching and the BPCC coded head.

Port of ``repro.serve.engine`` (pre-loaded queue, scalar steps).  A fixed
decode batch of ``n_slots`` sequences; a finished slot is refilled at once
by prefilling the next queued request into it.  Greedy sampling.

BPCC on the serving hot path:

  * with ``cfg.coded`` the LM-head matvec runs on the block-coded head:
    any ``coded_parity`` shards may be erased and the logits stay exact;
  * ``mask_fn`` supplies the per-step erasure mask, or ``latency_fn``
    per-shard latencies, from which the engine keeps the FIRST DECODABLE
    SUBSET (``first_decodable_mask``) and the mask-keyed ``DecoderCache``
    decodes it with one table gather;
  * a ``core.adaptive.ParityController`` picks the parity level per step
    from the straggler posterior, and with ``parity_topup`` the engine
    re-encodes the head with one more parity block ON DEVICE
    (``kernels.ops.encode_blocks_device``) when the posterior saturates
    the budget for ``topup_patience`` steps.

With ``mesh`` (a ``repro_torch.sharding.HeadMesh``) the coded head is
placed once, one code block per device, and every prefill and step runs
the mesh-sharded head (``core.coded_ops.coded_block_matmul``); a parity
raise places the re-encoded head again on the same mesh.

Host syncs: greedy argmax runs on the device and ``last_tok`` stays there;
each prefill and each decode step makes exactly one device-to-host copy
(``sync_count``).  The KV cache is updated in place; a prefill's cache is
spliced into its slot leaf by leaf, for the dense, ssm and hybrid layouts.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.registry import Model, build_model

if TYPE_CHECKING:
    from repro_torch.core.adaptive import ParityController

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int
    max_new_tokens: int = 16
    out_tokens: list[int] = field(default_factory=list)
    finish_step: int | None = None   # engine step count at retirement

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


def _batch_axis(name: str) -> int | None:
    """Batch-dim index of a cache leaf, by its name (the reference's
    ``_batch_axis``): pos [B]; k/v [..., B, s_max, kv, hd]; ssm
    [..., B, H, P, N]; conv [..., B, W-1, C]."""
    return {"pos": 0, "k": -4, "v": -4, "ssm": -4, "conv": -3}.get(name)


def _splice(full: Any, one: Any, slot: int, name: str) -> None:
    """Write the B = 1 cache ``one`` into batch row ``slot`` of ``full``."""
    if isinstance(full, dict):
        for key in full:
            _splice(full[key], one[key], slot, key)
        return
    if isinstance(full, list):
        for f, o in zip(full, one):
            _splice(f, o, slot, name)
        return
    ax = _batch_axis(name)
    if ax is None:
        return
    dst = full.select(ax, slot)
    src = one.select(ax, 0)
    if src.shape != dst.shape:
        dst.zero_()
        dst = dst[tuple(slice(0, n) for n in src.shape)]
    dst.copy_(src)


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params: Any,
        n_slots: int = 4,
        s_max: int = 256,
        mask_fn: Callable[[], np.ndarray] | None = None,
        eos_token: int | None = None,
        latency_fn: Callable[[], np.ndarray] | None = None,
        parity_controller: "ParityController | None" = None,
        parity_topup: int = 0,
        topup_patience: int = 4,
        encode_mode: str | None = None,
        mesh=None,
        head_axis: str = "model",
        head_kernel_mode: str | None = None,
        ssd_kernel_mode: str | None = None,
        scheduler=None,
        parity_policy=None,
        macro_steps: int = 1,
        device=None,
    ):
        """``device`` (default CUDA) must hold ``params``.  ``encode_mode`` is
        the kernel mode of the parity re-encode, ``head_kernel_mode`` that
        of the coded head and ``ssd_kernel_mode`` that of the SSD in every
        Mamba block's prefill; None means by device, the hand-written
        kernel on CUDA and its plain version on the CPU.  ``mesh`` (a
        ``HeadMesh`` with axis ``head_axis`` and one device per code block)
        shards the coded head; it needs a coded config.  ``scheduler``,
        ``parity_policy`` and ``macro_steps > 1`` are not ported yet and
        raise."""
        for name, val in (("scheduler", scheduler), ("parity_policy", parity_policy)):
            if val is not None:
                raise NotImplementedError(f"ServeEngine({name}=...) is not ported yet")
        if macro_steps != 1:
            raise NotImplementedError("fused macro-steps (macro_steps > 1) are not ported yet")
        self.device = default_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs on {self.device}")
        self.model = model
        self.params = model.prepare(params)
        self.n_slots, self.s_max = n_slots, s_max
        self.mask_fn = mask_fn
        self.latency_fn = latency_fn
        self.parity_controller = parity_controller
        self.parity_topup = parity_topup
        self.topup_patience = topup_patience
        self.encode_mode = encode_mode
        self.head_kernel_mode = head_kernel_mode
        self.ssd_kernel_mode = ssd_kernel_mode
        self.parity_events: list[dict] = []
        self._saturated_steps = 0
        self._steps = 0
        self.sync_count = 0         # device->host transfers on the hot path
        self.tokens_emitted = 0     # tokens appended to request outputs
        self._pending_splice: list[tuple[int, Any]] = []
        self.eos_token = eos_token
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.cache = model.init_cache(n_slots, s_max, self.device)
        self._last_tok = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self._active = np.zeros(n_slots, bool)
        if model.cfg.coded:
            from repro_torch.models.config import coded_blocks

            self._n_blocks = coded_blocks(model.cfg)
        self._mesh = mesh
        if mesh is not None:
            if not model.cfg.coded:
                raise ValueError("mesh-sharded head requires a coded model config")
            from repro_torch.sharding.policy import shard_coded_head, validate_coded_head_mesh

            validate_coded_head_mesh(mesh, self._n_blocks, head_axis)
            # place the coded head once, so no step moves the weight
            self.params["lm_head_coded"] = shard_coded_head(self.params["lm_head_coded"], mesh)
        self.completed: list[Request] = []

    # ------------------------------------------------------------------
    def _decode(self, cache, last_tok, mask):
        logits, cache = self.model.decode_step(
            self.params, cache, last_tok, mask, head_kernel_mode=self.head_kernel_mode,
            head_mesh=self._mesh)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _prefill1(self, tokens):
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": tokens}, s_max=self.s_max,
            head_kernel_mode=self.head_kernel_mode, head_mesh=self._mesh,
            ssd_kernel_mode=self.ssd_kernel_mode)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache1

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _insert_slot(self, slot: int, req: Request) -> None:
        """Prefill one request (B=1) and stage its cache for the batch; the
        splice itself is deferred to ``_flush_splices``."""
        tokens = torch.as_tensor(np.asarray(req.prompt)[None], dtype=torch.long,
                                 device=self.device)
        tok1, cache1 = self._prefill1(tokens)
        self._pending_splice.append((slot, cache1))
        self._last_tok[slot] = tok1[0]              # device-side
        req.out_tokens.append(int(tok1.cpu()[0]))   # the ONE host transfer
        self.sync_count += 1
        self.tokens_emitted += 1
        self.slots[slot] = req
        self._active[slot] = True

    def _flush_splices(self) -> None:
        """Copy every staged prefill cache into its slot of the batch cache,
        in place, leaf by leaf on that leaf's batch axis (``_batch_axis``).
        A prefill leaf shorter than the slot (a conv tail of a prompt under
        W-1 tokens) is zero-padded at the end, as the reference's splice
        pads; K/V come already zero-padded to ``s_max``, so copying the whole
        slot also clears what an earlier occupant left in the tail.  A slot
        admitted twice in one pass keeps the LAST cache, as sequential
        splices would."""
        if not self._pending_splice:
            return
        by_slot: dict[int, Any] = {}
        for slot, cache1 in self._pending_splice:
            by_slot[slot] = cache1
        self._pending_splice = []
        for slot in sorted(by_slot):
            _splice(self.cache, by_slot[slot], slot, "")

    def _finish_slot(self, slot: int, req: Request) -> None:
        """Retire a request and free its slot — the one completion path."""
        req.finish_step = self._steps
        self.completed.append(req)
        self._active[slot] = False
        self.slots[slot] = None

    def _prefill_done(self, req: Request) -> bool:
        """Did the prefill's own first token already end this request?"""
        hit_eos = (
            self.eos_token is not None
            and req.out_tokens
            and req.out_tokens[-1] == self.eos_token
        )
        return req.done or hit_eos

    def _refill(self) -> None:
        """One admission pass from the queue; all admitted caches land in
        one splice pass."""
        try:
            for s in range(self.n_slots):
                if not self._active[s] and self.queue:
                    req = self.queue.popleft()
                    self._insert_slot(s, req)
                    if self._prefill_done(req):
                        self._finish_slot(s, req)
        finally:
            self._flush_splices()

    def _raise_parity(self) -> None:
        """Re-encode the coded head with ONE more parity block, on device:
        a (n_data-1, n_parity+1) re-split from the fp32 head weight through
        the encode kernel, placed again on the engine's mesh if it has one."""
        from repro_torch.kernels.ops import encode_blocks_device

        cfg = self.model.cfg
        new_parity = cfg.coded_parity + 1
        head = (
            self.params["lm_head"]
            if "lm_head" in self.params
            else self.params["embed"].T
        )
        placed = self.params["lm_head_coded"]
        pdt = (placed if self._mesh is None else placed[0]).dtype
        coded = encode_blocks_device(
            head.T.to(torch.float32),
            self._n_blocks - new_parity,
            new_parity,
            mode=self.encode_mode,
        )
        # a new dict, so a caller's params keep their original coded head
        self.params = dict(self.params)
        coded = coded.to(pdt)
        if self._mesh is not None:
            from repro_torch.sharding.policy import shard_coded_head

            coded = shard_coded_head(coded, self._mesh)
        self.params["lm_head_coded"] = coded
        self.model = build_model(dataclasses.replace(cfg, coded_parity=new_parity))
        self.parity_topup -= 1
        self._saturated_steps = 0
        self.parity_events.append({
            "step": self._steps,
            "n_parity": new_parity,
            "encode_mode": self.encode_mode,
        })

    # ------------------------------------------------------------------
    def _control_step(self) -> np.ndarray | None:
        """One step's host control plane: observe latencies, run the
        saturation top-up, pick the parity level and commit this step's
        erasure mask (None when the head is uncoded or unmasked)."""
        if self.model.cfg.coded and self.latency_fn is not None:
            from repro_torch.core.decoding import first_decodable_mask

            lat = np.asarray(self.latency_fn(), np.float64)
            if self.mask_fn is not None:  # dead shards never count as fast
                lat = np.where(np.asarray(self.mask_fn()) > 0.5, lat, np.inf)
            n_blocks = self._n_blocks
            n_par = self.model.cfg.coded_parity
            if self.parity_controller is not None:
                self.parity_controller.observe(lat)
                believed = int((self.parity_controller.posterior > 0.5).sum())
                if believed > n_par and self.parity_topup > 0:
                    self._saturated_steps += 1
                    if self._saturated_steps >= self.topup_patience:
                        self._raise_parity()
                        n_par = self.model.cfg.coded_parity
                else:
                    self._saturated_steps = 0
                n_par = self.parity_controller.parity_level(n_par)
            return np.asarray(
                first_decodable_mask(lat, n_blocks - n_par, n_par), np.float32
            )
        if self.mask_fn is not None and self.model.cfg.coded:
            return np.asarray(self.mask_fn(), np.float32)
        return None

    def _apply_step(self, toks: np.ndarray) -> None:
        """Post-decode bookkeeping for one step's [n_slots] token row."""
        for s in range(self.n_slots):
            if not self._active[s]:
                continue
            req = self.slots[s]
            tok = int(toks[s])
            req.out_tokens.append(tok)
            self.tokens_emitted += 1
            hit_eos = self.eos_token is not None and tok == self.eos_token
            if req.done or hit_eos:
                self._finish_slot(s, req)

    def step(self) -> int:
        """One batched decode step; returns the number of active sequences."""
        self._refill()
        if not self._active.any():
            return 0
        self._steps += 1
        m = self._control_step()
        mask = None if m is None else torch.as_tensor(m, device=self.device)
        toks_dev, self.cache = self._decode(self.cache, self._last_tok, mask)
        self._last_tok = toks_dev           # feeds the next step on device
        toks = toks_dev.cpu().numpy()       # the ONE host transfer per step
        self.sync_count += 1
        self._apply_step(toks)
        return int(self._active.sum())

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drain the queue; returns the completed requests."""
        for _ in range(max_steps):
            busy = self.step()
            if busy == 0 and not self.queue:
                break
        return self.completed
