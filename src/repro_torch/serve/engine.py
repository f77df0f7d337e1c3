"""Batched serving engine with continuous batching and the BPCC coded head.

Port of ``repro.serve.engine``.  A fixed decode batch of ``n_slots``
sequences; a finished slot is refilled at once by prefilling the next
request into it, from the queue or, with a ``serve.scheduler.TraceScheduler``,
from an open-loop arrival trace with deadlines and admission control.
Greedy sampling.

BPCC on the serving hot path:

  * with ``cfg.coded`` the LM-head matvec runs on the block-coded head:
    any ``coded_parity`` shards may be erased and the logits stay exact;
  * ``mask_fn`` supplies the per-step erasure mask, or ``latency_fn``
    per-shard latencies, from which the engine keeps the FIRST DECODABLE
    SUBSET (``first_decodable_mask``) and the mask-keyed ``DecoderCache``
    decodes it with one table gather;
  * a ``core.adaptive.ParityController`` picks the parity level per step
    from the straggler posterior, or a ``DeadlineAwareParity`` policy from
    the posterior and the scheduler's SLO slack (per class for a
    ``TenantDeadlineParity``); with ``parity_topup`` the engine re-encodes
    the head with one more parity block ON DEVICE
    (``kernels.ops.encode_blocks_device``) when the posterior saturates
    the budget for ``topup_patience`` steps.

With ``mesh`` (a ``repro_torch.sharding.HeadMesh``) the coded head is
placed once, one code block per device, and every prefill and step runs
the mesh-sharded head (``core.coded_ops.coded_block_matmul``); a parity
raise places the re-encoded head again on the same mesh.

Host syncs: greedy argmax runs on the device and ``last_tok`` stays there;
each prefill and each scalar decode step makes exactly one device-to-host
copy (``sync_count``).  The cache is the engine's own and keeps its
tensors for its life: K/V are written in place by the step, a step's new
``pos`` and Mamba states are copied back into it, and a prefill's cache is
spliced into its slot leaf by leaf, for the layouts of all six families
(a vlm or encdec slot also takes its request's cross K/V).  A vlm request
carries its image embeddings (``Request.img_embed``); an encdec request is
served from zero source frames of its prompt's length, as the reference's
engine serves it.

Fused macro-steps: with ``macro_steps=K_max > 1``, ``macro_step()`` decodes
K steps with ONE host copy of the [K, n_slots] tokens when the batch is
full and the control plane has nothing to do mid-block (``_choose_k``, as
the reference).  The K control steps run on the host first, scalar-exact;
the token rows then replay through the scalar bookkeeping.  On the card the
K steps are one CUDA graph per K bucket, captured at first use and
replayed after that; elsewhere a loop of K steps.  Both routes decode the
same cache as the scalar step, so they are bit-identical to it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.kernels import count_kernel_nodes, count_wide_nodes, graph_dot, kernel_wrappers
from repro_torch.models.registry import Model, build_model
from repro_torch.sharding.ctx import macro_step_k

if TYPE_CHECKING:
    from repro_torch.core.adaptive import DeadlineAwareParity, ParityController
    from repro_torch.serve.scheduler import TraceScheduler

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int
    max_new_tokens: int = 16
    img_embed: np.ndarray | None = None   # [n_img, D] (vlm: required)
    out_tokens: list[int] = field(default_factory=list)
    deadline: float | None = None    # absolute SLO (scheduler-driven mode)
    sched_idx: int | None = None     # TraceScheduler request index
    finish_step: int | None = None   # engine step count at retirement

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens


def _batch_axis(name: str) -> int | None:
    """Batch-dim index of a cache leaf, by its name (the reference's
    ``_batch_axis``): pos [B]; k/v [..., B, s_max, kv, hd]; the cross K/V
    ck/cv [..., B, S_src, kv, hd]; ssm [..., B, H, P, N]; conv
    [..., B, W-1, C]."""
    return {"pos": 0, "k": -4, "v": -4, "ck": -4, "cv": -4, "ssm": -4, "conv": -3}.get(name)


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


def _commit(dst: Any, src: Any) -> None:
    """Copy a step's returned cache ``src`` into the engine's cache ``dst``
    where its leaves are new tensors (``pos`` and the Mamba states); K/V,
    written in place by the step, are ``dst``'s own tensors and skipped."""
    if isinstance(dst, dict):
        for key in dst:
            _commit(dst[key], src[key])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _commit(d, s)
    elif src is not dst:
        dst.copy_(src)


def _conv_leaves_to(cache: Any, dtype: torch.dtype, name: str = "") -> Any:
    """``cache`` with its Mamba conv leaves in ``dtype``."""
    if isinstance(cache, dict):
        return {k: _conv_leaves_to(v, dtype, k) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_conv_leaves_to(v, dtype, name) for v in cache]
    return cache.to(dtype) if name == "conv" else cache


@dataclass
class _BlockGraph:
    """One K bucket's captured block."""

    graph: Any                  # torch.cuda.CUDAGraph
    toks: torch.Tensor          # [k, n_slots] int32, written by every replay
    launches: dict[str, int]    # kernel nodes of the graph (launches a replay), by kernel name
    wide: dict[str, int]        # of those, the wide engine's (csrc/wide_rows.cuh), by head kernel


class ServeEngine:
    # the head kernels whose wide-engine launches (x of WIDE_MIN_B columns
    # and more) are also counted on their own
    _WIDE = ("coded_matvec", "coded_matvec_decode")

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
        scheduler: "TraceScheduler | None" = None,
        parity_policy: "DeadlineAwareParity | None" = None,
        clock: Callable[[], float] | None = None,
        prefill_budget: int | None = None,
        macro_steps: int = 1,
        device=None,
    ):
        """``device`` (default CUDA) must hold ``params``.  ``encode_mode`` is
        the kernel mode of the parity re-encode, ``head_kernel_mode`` that
        of the coded head and ``ssd_kernel_mode`` that of the SSD in every
        Mamba block's prefill; None means by device, the hand-written
        kernel on CUDA and its plain version on the CPU, and ``'auto'`` the
        per-shape dispatch (``repro_torch.kernels.dispatch``; inside a fused
        block of K steps it resolves at ``macro_step_k(K)``).  ``mesh`` (a
        ``HeadMesh`` with axis ``head_axis`` and one device per code block)
        shards the coded head; it needs a coded config.

        ``scheduler`` switches admission to a trace-driven ``TraceScheduler``
        whose payloads are ``Request`` objects; ``parity_policy`` (a
        ``DeadlineAwareParity``) replaces the controller's level with the
        deadline-aware rule and must wrap ``parity_controller`` when both
        are given; ``clock`` supplies "now" (default ``time.monotonic``);
        ``prefill_budget`` stops a step's admissions once its prompt tokens
        reach the budget (the first admission always lands).

        ``macro_steps`` is K_max of the fused macro-step decode (1 keeps
        every step scalar).  On CUDA a fused block is a captured CUDA graph;
        a head the card cannot capture raises NotImplementedError here: its
        decode through ``svd_recovery`` (the 'svd' mode, or a geometry the
        DecoderCache refuses, now or after the allowed raises) or a mesh
        over more than one card."""
        if parity_policy is not None:
            if parity_controller is None:
                parity_controller = parity_policy.controller
            elif parity_controller is not parity_policy.controller:
                raise ValueError(
                    "parity_policy wraps a different ParityController than "
                    "the one passed explicitly"
                )
        if macro_steps < 1:
            raise ValueError("macro_steps must be >= 1")
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
        self.parity_policy = parity_policy
        self.scheduler = scheduler
        self._clock = time.monotonic if clock is None else clock
        self.parity_topup = parity_topup
        self.topup_patience = topup_patience
        self.prefill_budget = prefill_budget
        self.encode_mode = encode_mode
        self.head_kernel_mode = head_kernel_mode
        self.ssd_kernel_mode = ssd_kernel_mode
        self.macro_steps = int(macro_steps)
        self.parity_events: list[dict] = []
        self._saturated_steps = 0
        self._steps = 0
        self.sync_count = 0         # device->host transfers on the hot path
        self.tokens_emitted = 0     # tokens appended to request outputs
        self.macro_blocks = 0       # fused blocks launched (K > 1)
        self.splice_rebuilds = 0    # splice passes over the batch cache (refill)
        self._pending_splice: list[tuple[int, Any]] = []
        # control decision computed for a step that has not decoded yet: set
        # when a mid-block parity raise truncates a fused block
        self._pending_ctrl: tuple | None = None
        self.eos_token = eos_token
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        # the engine's cache for its life.  A decode step's conv tail comes
        # out in the activation dtype and is copied back into this cache, so
        # its conv leaves hold that dtype (bf16 prefill tails widen exactly
        # into float32: the same values the reference's cache carries)
        self.cache = _conv_leaves_to(model.init_cache(n_slots, s_max, self.device),
                                     getattr(torch, model.cfg.dtype))
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
        # CUDA graphs of the fused blocks
        self._graphed = self.macro_steps > 1 and self.device.type == "cuda"
        if self._graphed:
            self._check_capturable()
            # a captured block reads its masks from here; a head with no mask
            # source decodes unmasked, as the scalar step does
            masked = model.cfg.coded and (mask_fn is not None or latency_fn is not None)
            self._mask_buf = (torch.zeros((self.macro_steps, self._n_blocks), dtype=torch.float32,
                                          device=self.device)
                              if masked else None)
            self._capture_stream = torch.cuda.Stream(self.device)
        self.graph_log: list[dict] = []   # one entry a capture
        self.graph_replays = 0
        self._bind()
        self.completed: list[Request] = []

    def _check_capturable(self) -> None:
        cfg = self.model.cfg
        if not cfg.coded:
            return
        from repro_torch.core.decoding import cacheable

        if self.head_kernel_mode == "svd":
            raise NotImplementedError(
                "fused blocks on CUDA with head_kernel_mode='svd': svd_recovery's float64 "
                "pinv and host-built generator cannot be captured in a CUDA graph")
        for n_par in range(cfg.coded_parity, cfg.coded_parity + max(self.parity_topup, 0) + 1):
            if not cacheable(self._n_blocks - n_par, n_par):
                raise NotImplementedError(
                    f"fused blocks on CUDA with a ({self._n_blocks - n_par}, {n_par}) head: the "
                    f"DecoderCache refuses that geometry, and its svd_recovery decode cannot be "
                    f"captured in a CUDA graph")
        if self._mesh is not None and len(set(self._mesh.devices)) > 1:
            raise NotImplementedError(
                "fused blocks on CUDA with a head mesh over several cards: one CUDA graph "
                "cannot hold the launches and copies of more than one device")

    def _bind(self) -> None:
        """Forget every captured block and first-call record: at build time
        and after a parity raise, whose new head and model invalidate what
        the graphs recorded (the reference re-jits here)."""
        self._graphs: dict[int, _BlockGraph] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if self._graphed else None
        # first call of each (kind, K) bucket since the (re-)bind: excluded
        # from the scheduler's step-time estimate, as the reference excludes
        # its compile; on the card a block's first call is its capture
        self._compiled: set[tuple[str, int]] = set()

    # ------------------------------------------------------------------
    def _decode(self, cache, last_tok, mask, model=None, params=None):
        model = self.model if model is None else model
        logits, cache = model.decode_step(
            self.params if params is None else params, cache, last_tok, mask,
            head_kernel_mode=self.head_kernel_mode, head_mesh=self._mesh)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _prefill1(self, batch: dict):
        logits, cache1 = self.model.prefill(
            self.params, batch, s_max=self.s_max,
            head_kernel_mode=self.head_kernel_mode, head_mesh=self._mesh,
            ssd_kernel_mode=self.ssd_kernel_mode)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache1

    def _commit_step(self, cache, toks_dev) -> None:
        """Carry a step's cache and tokens into the engine's own tensors."""
        _commit(self.cache, cache)
        self._last_tok.copy_(toks_dev)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _insert_slot(self, slot: int, req: Request) -> None:
        """Prefill one request (B=1) and stage its cache for the batch; the
        splice itself is deferred to ``_flush_splices``.  A vlm request
        brings its image embeddings; an encdec request gets zero source
        frames of its prompt's length, as the reference's engine gives."""
        batch = {"tokens": torch.as_tensor(np.asarray(req.prompt)[None], dtype=torch.long,
                                           device=self.device)}
        if req.img_embed is not None:
            batch["img_embed"] = torch.as_tensor(np.asarray(req.img_embed)[None],
                                                 device=self.device)
        if self.model.cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, len(req.prompt), self.model.cfg.d_model),
                                          dtype=torch.float32, device=self.device)
        tok1, cache1 = self._prefill1(batch)
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
        W-1 tokens, an encdec request's cross K/V of its prompt's length
        against the slot's s_max rows) is zero-padded at the end, as the
        reference's splice pads (a decode step then attends the zero cross
        rows too, as the reference's does); K/V come already zero-padded to ``s_max``, so copying the whole
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
        self.splice_rebuilds += 1

    def _finish_slot(self, slot: int, req: Request, now: float | None) -> None:
        """Retire a request and free its slot — the one completion path."""
        if self.scheduler is not None and req.sched_idx is not None:
            self.scheduler.on_finish(req.sched_idx, now)
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

    def _refill(self, now: float | None = None) -> None:
        """One admission pass; all admitted caches land in one splice pass."""
        try:
            self._admit_refill(now)
        finally:
            self._flush_splices()

    def _admit_refill(self, now: float | None = None) -> None:
        if self.scheduler is not None:
            prompt_spent = 0
            while True:
                free = int(self.n_slots - self._active.sum())
                if free <= 0:
                    return
                admitted = self.scheduler.admit(now, 1)
                if not admitted:
                    return
                sreq = admitted[0]
                req = sreq.payload
                if not isinstance(req, Request):
                    raise TypeError(
                        "scheduler-driven engine needs Request payloads on "
                        "the TraceScheduler trace"
                    )
                if req.max_new_tokens != sreq.n_tokens:
                    raise ValueError(
                        f"request {req.uid}: payload token budget "
                        f"{req.max_new_tokens} != trace n_tokens "
                        f"{sreq.n_tokens} — the engine and scheduler would "
                        f"disagree on completion"
                    )
                req.sched_idx = sreq.idx
                req.deadline = sreq.deadline
                slot = int(np.flatnonzero(~self._active)[0])
                self._insert_slot(slot, req)
                prompt_spent += len(req.prompt)
                # the prefill's token is stamped with a FRESH clock read:
                # the prefill took real time, and a pre-prefill stamp would
                # count deadline-expired requests as met
                t_tok = self._clock()
                done = self.scheduler.on_token(sreq.idx, t_tok)
                if done or self._prefill_done(req):
                    self._finish_slot(slot, req, t_tok)
                if self.prefill_budget is not None and (
                    prompt_spent >= self.prefill_budget
                ):
                    return
        else:
            for s in range(self.n_slots):
                if not self._active[s] and self.queue:
                    req = self.queue.popleft()
                    self._insert_slot(s, req)
                    if self._prefill_done(req):
                        self._finish_slot(s, req, None)

    def _raise_parity(self) -> None:
        """Re-encode the coded head with ONE more parity block, on device:
        a (n_data-1, n_parity+1) re-split from the fp32 head weight through
        the encode kernel, placed again on the engine's mesh if it has one.
        Every captured block is dropped (``_bind``)."""
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
        self._bind()
        self.parity_topup -= 1
        self._saturated_steps = 0
        self.parity_events.append({
            "step": self._steps,
            "n_parity": new_parity,
            "encode_mode": self.encode_mode,
        })

    # ------------------------------------------------------------------
    def _control_step(self, now: float | None) -> np.ndarray | None:
        """One step's host control plane: observe latencies through the
        parity policy or controller, run the saturation top-up, pick the
        parity level and commit this step's erasure mask (None when the
        head is uncoded or unmasked).  The fused path calls it once per
        fused step before the block launches, so controller state moves
        exactly as in the scalar loop."""
        if self.model.cfg.coded and self.latency_fn is not None:
            from repro_torch.core.decoding import first_decodable_mask

            lat = np.asarray(self.latency_fn(), np.float64)
            if self.mask_fn is not None:  # dead shards never count as fast
                lat = np.where(np.asarray(self.mask_fn()) > 0.5, lat, np.inf)
            n_blocks = self._n_blocks
            n_par = self.model.cfg.coded_parity
            if self.parity_controller is not None:
                # the policy observes the same stream as its controller
                if self.parity_policy is not None:
                    self.parity_policy.observe(lat)
                else:
                    self.parity_controller.observe(lat)
                believed = int((self.parity_controller.posterior > 0.5).sum())
                if believed > n_par and self.parity_topup > 0:
                    self._saturated_steps += 1
                    if self._saturated_steps >= self.topup_patience:
                        self._raise_parity()
                        n_par = self.model.cfg.coded_parity
                else:
                    self._saturated_steps = 0
                if self.parity_policy is not None:
                    # deadline-aware level from the SLO slack in estimated
                    # steps (+inf without a scheduler); a per-tenant policy
                    # gets the per-class slack vector
                    from repro_torch.core.adaptive import TenantDeadlineParity

                    if self.scheduler is None:
                        slack: Any = np.inf
                    elif isinstance(self.parity_policy, TenantDeadlineParity):
                        slack = self.scheduler.class_slack_steps(now)
                    else:
                        slack = self.scheduler.min_slack_steps(now)
                    n_par = self.parity_policy.level(n_par, slack)
                else:
                    n_par = self.parity_controller.parity_level(n_par)
            return np.asarray(
                first_decodable_mask(lat, n_blocks - n_par, n_par), np.float32
            )
        if self.mask_fn is not None and self.model.cfg.coded:
            return np.asarray(self.mask_fn(), np.float32)
        return None

    def _apply_step(self, toks: np.ndarray, t_done: float | None) -> None:
        """Post-decode bookkeeping for one step's [n_slots] token row:
        outputs, EOS, scheduler completion, slot retirement."""
        for s in range(self.n_slots):
            if not self._active[s]:
                continue
            req = self.slots[s]
            tok = int(toks[s])
            req.out_tokens.append(tok)
            self.tokens_emitted += 1
            hit_eos = self.eos_token is not None and tok == self.eos_token
            done_sched = False
            if self.scheduler is not None and req.sched_idx is not None:
                done_sched = self.scheduler.on_token(req.sched_idx, t_done)
            if req.done or hit_eos or done_sched:
                self._finish_slot(s, req, t_done)

    def _scalar_decode(self, m: np.ndarray | None, model=None, params=None) -> np.ndarray:
        """One decode step carried into the engine's cache; the [n_slots]
        tokens through the ONE host transfer of the step."""
        mask = None if m is None else torch.as_tensor(m, device=self.device)
        toks_dev, cache = self._decode(self.cache, self._last_tok, mask, model, params)
        self._commit_step(cache, toks_dev)  # the next step reads them on device
        self.sync_count += 1
        return toks_dev.cpu().numpy()

    def step(self) -> int:
        """One batched decode step; returns the number of active sequences."""
        now = self._clock() if self.scheduler is not None else None
        self._refill(now)
        if not self._active.any():
            return 0
        self._steps += 1
        if self._pending_ctrl is not None:
            # a truncated fused block already ran this step's control
            m = self._pending_ctrl[0]
            self._pending_ctrl = None
        else:
            m = self._control_step(now)
        # step time starts after the refill: prefills are admission work
        t_decode0 = self._clock() if self.scheduler is not None else None
        toks = self._scalar_decode(m)
        t_done = None
        if self.scheduler is not None:
            t_done = self._clock()
            if ("decode", 1) in self._compiled:
                self.scheduler.observe_step(t_done - t_decode0)
            else:
                self._compiled.add(("decode", 1))
        elif ("decode", 1) not in self._compiled:
            self._compiled.add(("decode", 1))
        self._apply_step(toks, t_done)
        return int(self._active.sum())

    # ------------------------------------------------------------------
    # fused macro-step decode
    # ------------------------------------------------------------------
    def _ctrl_snapshot(self) -> tuple:
        """Controller and policy state, to roll back the control decisions
        of fused steps that never decode (the batch drained mid-block)."""
        ctrl, pol = self.parity_controller, self.parity_policy
        return (
            None if ctrl is None else ctrl.posterior.copy(),
            None if pol is None else (
                pol._onset_rate, pol._spike, pol._calm_steps
            ),
            self._saturated_steps,
        )

    def _ctrl_restore(self, snap: tuple) -> None:
        post, pol_state, sat = snap
        if post is not None:
            self.parity_controller.posterior = post
        if pol_state is not None:
            pol = self.parity_policy
            pol._onset_rate, pol._spike, pol._calm_steps = pol_state
        self._saturated_steps = sat

    def _choose_k(self) -> int:
        """Fused block length for the next macro-step: 1 whenever a control
        decision could differ mid-block (queued work, a free slot, prefill
        debt, an imminent arrival, scarce slack, a controller near its
        raise); at batch-full steady state up to ``macro_steps``, quantised
        down to a power of two so the buckets stay few."""
        if self.macro_steps <= 1 or not self._active.any():
            return 1
        if self.queue or not self._active.all():
            return 1
        k = self.macro_steps
        # after the longest remaining budget the batch has drained (EOS can
        # empty it earlier; the replay rolls the extra control steps back)
        rem = max(
            req.max_new_tokens - len(req.out_tokens)
            for s, req in enumerate(self.slots)
            if self._active[s]
        )
        k = min(k, max(rem, 1))
        sched = self.scheduler
        if sched is not None:
            now = self._clock()
            if sched.pending(now) > 0 or sched.has_prefill_debt:
                return 1
            est = max(sched.est_step_time, 1e-12)
            nxt = sched.next_arrival()
            if nxt is not None:
                # never decode past the next arrival's admission step
                k = min(k, max(1, int((nxt - now) / est)))
            if self.parity_policy is not None:
                # never fuse past the point slack could force escalation
                esc = max(
                    getattr(self.parity_policy, "class_escalate",
                            (self.parity_policy.escalate_steps,))
                )
                slack = sched.min_slack_steps(now)
                if np.isfinite(slack):
                    k = min(k, max(1, int(slack - esc)))
        if self.parity_controller is not None and self.parity_topup > 0:
            believed = int((self.parity_controller.posterior > 0.5).sum())
            if self._saturated_steps > 0 or believed >= self.model.cfg.coded_parity:
                return 1  # a top-up raise may be steps away
        p = 1
        while p * 2 <= k:
            p *= 2
        return p

    def _run_block(self, k: int, masks: torch.Tensor | None, toks: torch.Tensor) -> None:
        """K chained decode steps from the engine's cache: row t of ``toks``
        [k, n_slots] gets step t's tokens, then the last tokens and the
        carried cache leaves go back into the engine's tensors.  The body
        of a captured block, and the block itself off the card."""
        cache, lt = self.cache, self._last_tok
        with macro_step_k(k):
            for t in range(k):
                lt, cache = self._decode(cache, lt, None if masks is None else masks[t])
                toks[t].copy_(lt)
        self._commit_step(cache, lt)

    def _capture(self, k: int) -> _BlockGraph:
        """Capture bucket ``k`` into a CUDA graph in the bind's memory pool.

        One eager step first, on the capture stream, does the first-use
        work a capture cannot (table uploads, plan queries, library and
        handle set-up).  It decodes from the engine's cache and keeps
        nothing: its only write, each slot's K/V at ``pos``, is written
        again with the same values by the block's first step before
        anything reads it.  Its kernel launches are real and counted.  The
        launches a replay makes are read from the captured graph's kernel
        nodes, and must be what the wrappers recorded into it.  Both run
        under ``macro_step_k(k)``, so an ``'auto'`` head's decision for the
        K-step block is the one the graph holds."""
        dev = self.device
        wrappers = kernel_wrappers()
        stream = self._capture_stream
        masks = self._mask_buf
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), macro_step_k(k):
            self._decode(self.cache, self._last_tok, None if masks is None else masks[0])
        torch.cuda.current_stream(dev).wait_stream(stream)
        toks = torch.empty((k, self.n_slots), dtype=torch.int32, device=dev)
        recorded = {name: fn.captured for name, fn in wrappers.items()}
        wide0 = {name: wrappers[name].wide_captured for name in self._WIDE}
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept, so its nodes can be counted
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
            self._run_block(k, masks, toks)
        recorded = {name: fn.captured - recorded[name] for name, fn in wrappers.items()}
        wide = {name: wrappers[name].wide_captured - wide0[name] for name in self._WIDE}
        dot = graph_dot(graph)
        nodes, wide_nodes = count_kernel_nodes(dot), count_wide_nodes(dot)
        graph.instantiate()
        if nodes != recorded or wide_nodes != wide:
            raise RuntimeError(f"the K={k} graph holds kernel nodes {nodes} (wide "
                               f"{wide_nodes}), but the wrappers recorded {recorded} "
                               f"(wide {wide})")
        self.graph_log.append({
            "k": k, "n_parity": self.model.cfg.coded_parity if self.model.cfg.coded else 0,
            "launches_per_replay": {name: n for name, n in nodes.items() if n},
        })
        blk = self._graphs[k] = _BlockGraph(graph, toks, nodes, wide_nodes)
        return blk

    def _launch_block(self, k: int, masks: list) -> np.ndarray:
        """Decode ``k`` steps with ONE host copy of the [k, n_slots] tokens:
        a replay of the bucket's graph on the card (the masks go in with one
        copy), a loop of k steps elsewhere."""
        masked = masks[0] is not None
        if not self._graphed:
            mstack = torch.as_tensor(np.stack(masks), device=self.device) if masked else None
            toks = torch.empty((k, self.n_slots), dtype=torch.int32, device=self.device)
            self._run_block(k, mstack, toks)
            return toks.cpu().numpy()
        if masked != (self._mask_buf is not None):
            raise RuntimeError("a fused block's masks do not match the engine's mask source")
        if masked:
            self._mask_buf[:k].copy_(torch.from_numpy(np.stack(masks)))
        blk = self._graphs.get(k)
        if blk is None:
            blk = self._capture(k)
        blk.graph.replay()
        for name, fn in kernel_wrappers().items():
            fn.launches += blk.launches[name]
            if name in self._WIDE:
                fn.wide_launches += blk.wide[name]
        self.graph_replays += 1
        return blk.toks.cpu().numpy()

    def _fused_block(self, k: int) -> int:
        """Decode ``k`` steps in one block with ONE host sync.

        Control runs first, k times on the host (masks, posteriors, top-up
        checks, in scalar order); then the block runs and its [k, n_slots]
        token rows replay through the scalar bookkeeping.  Two truncations
        keep scalar equivalence:

          * a mid-block parity RAISE re-binds the model, so the pre-raise
            steps decode scalar-wise through the OLD model and params, and
            the post-raise control result is stashed for the next ``step()``;
          * the batch DRAINING mid-block (EOS) stops the replay early and
            rolls controller state back to the last executed step.
        """
        now = self._clock() if self.scheduler is not None else None
        self._refill(now)  # the K gate makes this a no-op; seam kept
        if not self._active.any():
            return 0
        s0 = self._steps
        n_events = len(self.parity_events)
        old_model, old_params = self.model, self.params
        comp_before = self._compiled
        snaps: list[tuple] = []
        masks: list[np.ndarray | None] = []
        raised = False
        for t in range(k):
            snaps.append(self._ctrl_snapshot())
            self._steps = s0 + t + 1  # raise events record scalar-exact steps
            m = self._control_step(now)
            if len(self.parity_events) > n_events:
                raised = True
                self._pending_ctrl = (m,)  # the post-raise step's control
                break
            masks.append(m)
        self._steps = s0
        k_exec = len(masks)
        if raised and k_exec == 0:
            return self.step()  # consumes the pending control immediately
        if raised:
            # degrade: the pre-raise steps belong to the old geometry
            executed = 0
            for t in range(k_exec):
                self._steps += 1
                t0 = self._clock() if self.scheduler is not None else None
                toks = self._scalar_decode(masks[t], old_model, old_params)
                t_done = None
                if self.scheduler is not None:
                    t_done = self._clock()
                    if ("decode", 1) in comp_before:
                        self.scheduler.observe_step(t_done - t0)
                    else:
                        comp_before.add(("decode", 1))
                self._apply_step(toks, t_done)
                executed += 1
                if not self._active.any():
                    break
            if not self._active.any():
                # the batch drained before the post-raise step ran: its
                # stashed control must not leak onto a future step
                self._pending_ctrl = None
                self._ctrl_restore(snaps[executed])
            return int(self._active.sum())
        fresh = ("decode", k) not in self._compiled
        self._compiled.add(("decode", k))
        t0 = self._clock() if self.scheduler is not None else None
        toks = self._launch_block(k, masks)  # THE one host transfer for the block
        self.sync_count += 1
        self.macro_blocks += 1
        t_done = None
        dt = 0.0
        if self.scheduler is not None:
            t_done = self._clock()
            dt = (t_done - t0) / k  # per-step share of the block time
        executed = 0
        for t in range(k):
            self._steps += 1
            if self.scheduler is not None and not fresh and dt > 0:
                # K equal observes of the block mean: the scalar loop's EW mass
                self.scheduler.observe_step(dt)
            self._apply_step(toks[t], t_done)
            executed += 1
            if not self._active.any():
                break
        if executed < k:
            # EOS drained the batch early: roll the trailing control back
            self._ctrl_restore(snaps[executed])
        return int(self._active.sum())

    def macro_step(self) -> int:
        """A fused block at batch-full steady state, a scalar ``step()``
        whenever the control plane needs per-step reactivity; with
        ``macro_steps=1`` it IS ``step()``."""
        if self.macro_steps <= 1 or self._pending_ctrl is not None:
            return self.step()
        k = self._choose_k()
        if k <= 1:
            return self.step()
        return self._fused_block(k)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drain the queue (or, with a scheduler, the trace: the caller's
        clock must pass the arrivals; see ``launch.serve`` for the
        wall-clock drive).  Iterates ``macro_step()``; returns the
        completed requests."""
        for _ in range(max_steps):
            busy = self.macro_step()
            if self.scheduler is not None:
                if self.scheduler.finished and busy == 0:
                    break
            elif busy == 0 and not self.queue:
                break
        return self.completed
