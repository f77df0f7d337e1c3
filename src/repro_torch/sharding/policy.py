"""Sharding policy: logical parameter/activation axes -> mesh specs, and
the coded serving head's mesh (one code block per device).

Port of ``repro.sharding.policy``.  Mesh axes: ``("data", "model")``
single-pod, ``("pod", "data", "model")`` multi-pod (a
``repro_torch.launch.mesh.LogicalMesh``, or anything with ``.shape`` and
``.axis_names``).  The policy implements, rule for rule as the reference:

  * **TP** over ``model``: attention heads, d_ff, vocab, MoE experts (EP),
    Mamba d_inner heads.
  * **DP** over ``("pod", "data")``: batch dims of activations/caches.
  * **FSDP/ZeRO** over ``data``: parameters' non-TP matrix axis (and the
    optimizer state, which inherits param specs).
  * **SP**: KV-cache sequence sharding (over ``model`` when the KV-head
    count doesn't divide TP, and over ``data`` when the decode batch is too
    small to fill DP: long_500k).

Every spec passes through ``fit()``: assignments whose dimension does not
divide by the axes are dropped, with the reference's named fallbacks
(contraction sharding of attention q/o when the heads do not divide TP;
vocab unsharded when it does not divide).  Rules are name+rank based over
tree paths (``blocks/attn_0/w_q``, list indices and a quantized moment's
``0`` (codes) and ``1`` (scales) as path parts, as
``repro_torch.utils.tree`` names them).

A spec is a :class:`Spec`, a tuple of one entry a dimension: None, an axis
name, or a tuple of axis names — the counterpart of a ``PartitionSpec``,
normalised as it is (a one-name tuple is the name).  One card holds no
mesh, so the specs are used for reckoning: :func:`device_bytes` is a tree's
bytes on each device under them (``repro_torch.launch.dryrun``).  Not
ported: ``param_shardings`` (``NamedSharding``s of a device mesh).

The coded serving head runs as one program over a 1-D mesh in the
reference; here a single controller holds that mesh as an explicit tuple
of ``torch.device``s, one per code block (:class:`HeadMesh`).  A device may
be named more than once: sixteen logical devices on one card
(``(cuda:0,) * 16``) are the counterpart of the reference's tests, which
force sixteen host devices onto one CPU.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten

__all__ = [
    "Spec",
    "ShardingPolicy",
    "make_policy",
    "param_specs",
    "device_bytes",
    "HeadMesh",
    "serve_head_mesh",
    "shard_coded_head",
    "validate_coded_head_mesh",
]


class Spec(tuple):
    """A partition spec: one entry a dimension (None, an axis name, or a
    tuple of names), normalised as ``PartitionSpec`` normalises (an empty
    tuple is None, a one-name tuple the name)."""

    def __new__(cls, *entries):
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = None if not e else (e[0] if len(e) == 1 else e)
            out.append(e)
        return super().__new__(cls, out)


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def _map_with_path(fn, tree):
    """``fn(path, leaf)`` over a tree, in its structure (the reference's
    ``tree_map_with_path`` over ShapeDtypeStructs)."""
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in flat])


@dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    fsdp: bool = True              # shard params over 'data' too (ZeRO-3 style)
    shard_cache_seq: bool = False  # SP on KV-cache sequence dim (tiny batches)
    vocab: int = 0                 # for logits hints divisibility
    qkv_contraction: bool = False  # force contraction-sharded attn projections
    # (decode cells whose KV cache is sequence-sharded; weights stay sharded)

    # ------------------------------------------------------------------
    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def fsdp_axis(self) -> str | None:
        return "data" if (self.fsdp and "data" in self.mesh.axis_names) else None

    def _axis_size(self, entry) -> int:
        if entry is None:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(self.mesh.shape[a] for a in axes)

    def fit(self, spec: tuple, shape: tuple) -> Spec:
        """Left-pad to rank and drop non-divisible axis assignments."""
        entries = (None,) * (len(shape) - len(spec)) + tuple(spec)
        out = []
        for dim, entry in zip(shape, entries):
            out.append(entry if entry and dim % self._axis_size(entry) == 0 else None)
        return Spec(*out)

    def divisible(self, dim: int, entry) -> bool:
        return dim % self._axis_size(entry) == 0

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_spec(self, path: str, shape: tuple) -> Spec:
        name = path.rsplit("/", 1)[-1]
        ndim = len(shape)
        fs = self.fsdp_axis
        both = ("data", "model") if fs else ("model",)
        if name == "embed":
            if self.divisible(shape[0], "model"):
                return self.fit(("model", fs), shape)
            return self.fit((None, fs), shape)
        if name in ("lm_head", "lm_head_coded"):
            # [D, V] (or coded blocks [nb*br, D]) — vocab over model if it fits
            if name == "lm_head" and self.divisible(shape[1], "model"):
                return self.fit((fs, "model"), shape)
            if name == "lm_head_coded" and self.divisible(shape[0], "model"):
                return self.fit(("model", fs), shape)
            return self.fit((fs, None), shape)
        if ndim <= 1 or name.startswith(
            ("ln", "gate_norm", "dt_bias", "a_log", "d_skip", "final_norm",
             "enc_norm", "gate")
        ):
            return Spec(*((None,) * ndim))
        is_moe = ("moe_" in path or "/moe/" in path) and "shared" not in path
        if name in ("w_gate", "w_up"):
            if is_moe:
                return self.fit(("model", fs, None), shape)   # [E, D, F]
            return self.fit((fs, "model"), shape)             # [D, F]
        if name == "w_down":
            if is_moe:
                return self.fit(("model", None, fs), shape)   # [E, F, D]
            return self.fit(("model", fs), shape)             # [F, D]
        if name == "router":
            return self.fit((fs, None), shape)                # [D, E]
        if name in ("w_q", "w_k", "w_v"):
            heads = shape[-2]
            if self.divisible(heads, "model") and not self.qkv_contraction:
                return self.fit((fs, "model", None), shape)   # [D, H, Hd]
            # fallback: contraction-shard d_model
            d = shape[-3]
            entry = both if self.divisible(d, both) else fs
            return self.fit((entry, None, None), shape)
        if name == "w_o":
            heads = shape[-3]
            if self.divisible(heads, "model") and not self.qkv_contraction:
                return self.fit(("model", None, fs), shape)   # [H, Hd, D]
            d = shape[-1]
            entry = both if self.divisible(d, both) else fs
            return self.fit((None, None, entry), shape)
        if name == "in_proj":
            return self.fit((fs, "model"), shape)             # [D, Zproj]
        if name == "out_proj":
            return self.fit(("model", fs), shape)             # [din, D]
        if name == "conv_w":
            return self.fit((None, "model"), shape)           # [W, C]
        return Spec(*((None,) * ndim))

    def param_specs(self, shapes: Any) -> Any:
        return _map_with_path(lambda path, x: self.param_spec(path, tuple(x.shape)), shapes)

    # ------------------------------------------------------------------
    # optimizer state (moments mirror params; QTensor q/scale children)
    # ------------------------------------------------------------------
    def opt_spec(self, path: str, shape: tuple) -> Spec:
        parts = path.split("/")
        if parts[0] == "step":
            return Spec()
        if parts[0] in ("m", "v"):
            if parts[-1] in ("0", "1"):  # QTensor children: 0 = q, 1 = scale
                base = self.param_spec("/".join(parts[1:-1]), shape)
                if parts[-1] == "1":  # scale: block axis (last) replicated
                    entries = tuple(base) + (None,) * (len(shape) - len(tuple(base)))
                    return self.fit(tuple(entries[:-1]) + (None,), shape)
                return self.fit(tuple(base), shape)
            return self.param_spec("/".join(parts[1:]), shape)
        return self.param_spec(path, shape)

    def opt_specs(self, shapes: Any) -> Any:
        return _map_with_path(lambda path, x: self.opt_spec(path, tuple(x.shape)), shapes)

    def state_specs(self, state_shapes: Any) -> Any:
        """Specs for a full TrainState {'params': ..., 'opt': ..[, 'err': ..]}.

        The ``err`` tree (error-feedback residuals for compressed coded
        messages) mirrors params with a leading [n_workers] message axis:
        that axis stays unsharded, the rest inherits the param spec."""

        def fn(ps, x):
            root, _, rest = ps.partition("/")
            if root == "params":
                return self.param_spec(rest, tuple(x.shape))
            if root == "err":
                base = tuple(self.param_spec(rest, tuple(x.shape[1:])))
                return self.fit((None,) + base, tuple(x.shape))
            return self.opt_spec(rest, tuple(x.shape))

        return _map_with_path(fn, state_shapes)

    # ------------------------------------------------------------------
    # inputs / batches
    # ------------------------------------------------------------------
    def batch_spec(self, path: str, shape: tuple) -> Spec:
        if len(shape) == 0:
            return Spec()
        return self.fit((self.dp_axes,) + (None,) * (len(shape) - 1), shape)

    def batch_specs(self, specs: Any) -> Any:
        return _map_with_path(lambda path, x: self.batch_spec(path, tuple(x.shape)), specs)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_spec(self, path: str, shape: tuple) -> Spec:
        name = path.rsplit("/", 1)[-1]
        ndim = len(shape)
        dp = self.dp_axes
        if name == "pos":
            return Spec(*((None,) * ndim))
        if name in ("k", "v", "ck", "cv"):
            # [, B, S, KVH, Hd] — heads on model when divisible; otherwise
            # flash-decode style: SEQUENCE over model (partial softmax)
            kvh = shape[-2]
            heads_fit = self.divisible(kvh, "model")
            if self.shard_cache_seq:  # tiny global batch (long_500k)
                spec: tuple = (None, "data", "model" if heads_fit else None, None)
                if not heads_fit:
                    spec = (None, ("data", "model"), None, None)
            else:
                spec = (dp, "model" if not heads_fit else None,
                        "model" if heads_fit else None, None)
            return self.fit(spec, shape)
        if name == "ssm":   # [, B, H, P, N]
            spec = (None, ("data", "model")) if self.shard_cache_seq else (dp, "model")
            return self.fit(spec + (None, None), shape)
        if name == "conv":  # [, B, W-1, C]
            spec = ((None,) if self.shard_cache_seq else (dp,)) + (None, "model")
            return self.fit(spec, shape)
        return Spec(*((None,) * ndim))

    def cache_specs(self, shapes: Any) -> Any:
        return _map_with_path(lambda path, x: self.cache_spec(path, tuple(x.shape)), shapes)

    # ------------------------------------------------------------------
    # activation hints (the reference installs them via repro.sharding.ctx)
    # ------------------------------------------------------------------
    def hints(self) -> dict[str, Spec]:
        dp = self.dp_axes
        h = {
            "act_bsd": Spec(dp, None, None),
            "act_bshp": Spec(dp, None, "model", None),
            "moe_ecd": Spec("model", None, None),
        }
        if self.vocab and self.vocab % self.mesh.shape.get("model", 1) == 0:
            h["logits_bsv"] = Spec(dp, None, "model")
        return h


def make_policy(
    mesh, cfg=None, *, fsdp: bool = True,
    shard_cache_seq: bool = False, qkv_contraction: bool = False,
) -> ShardingPolicy:
    return ShardingPolicy(
        mesh=mesh, fsdp=fsdp, shard_cache_seq=shard_cache_seq,
        vocab=cfg.vocab if cfg is not None else 0,
        qkv_contraction=qkv_contraction,
    )


def param_specs(shapes: Any, mesh, **kw) -> Any:
    return make_policy(mesh, **kw).param_specs(shapes)


def device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes of one device's share of ``tree`` under ``specs`` (a tree of
    the same structure, as the ``*_specs`` methods return it): Σ over the
    leaves of numel · itemsize / Π(sizes of the axes each dimension is
    sharded over).  Every sharded dimension divides (``fit`` saw to it), so
    the count is exact."""
    leaves = tree_flatten_with_path(tree)
    spec_leaves = tree_flatten_with_path(specs, is_leaf=_is_spec)
    if [p for p, _ in leaves] != [p for p, _ in spec_leaves]:
        raise ValueError("the specs' tree does not match the tree's")
    total = 0
    for (_, x), (_, spec) in zip(leaves, spec_leaves):
        div = 1
        for entry in spec:
            for axis in (() if entry is None else entry if isinstance(entry, tuple)
                         else (entry,)):
                div *= mesh.shape[axis]
        n = x.numel() * x.element_size()
        if n % div:
            raise ValueError(f"{tuple(x.shape)} does not divide under {spec}")
        total += n // div
    return total


def _present(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index resolved; raises
    ValueError for a card this machine does not have."""
    d = torch.device(device)
    if d.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = d.index if d.index is not None else (torch.cuda.current_device() if n else 0)
        if index >= n:
            raise ValueError(f"HeadMesh names {d}, but this machine has {n} CUDA device(s)")
        d = torch.device("cuda", index)
    return d


@dataclass(frozen=True)
class HeadMesh:
    """A 1-D head mesh: ``devices[i]`` holds code block i.  The counterpart
    of a 1-D ``Mesh`` with one axis named ``axis``."""

    devices: tuple[torch.device, ...]
    axis: str = "model"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a HeadMesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_present(d) for d in self.devices))


def serve_head_mesh(n_blocks: int, axis: str = "model") -> HeadMesh:
    """A head mesh with one card per coded head block: the first
    ``n_blocks`` CUDA devices.  Raises with fewer, as the reference does;
    name a device repeatedly in a ``HeadMesh`` to put several blocks on one
    card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_blocks:
        raise ValueError(
            f"serve_head_mesh needs {n_blocks} devices (one per code block), have {n}")
    return HeadMesh(tuple(torch.device("cuda", i) for i in range(n_blocks)), axis)


def validate_coded_head_mesh(mesh: HeadMesh, n_blocks: int, axis: str = "model") -> None:
    """Raise ValueError unless ``mesh`` has axis ``axis`` with exactly one
    device per code block."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {(mesh.axis,)})")
    size = len(mesh.devices)
    if size != n_blocks:
        raise ValueError(
            f"coded head has {n_blocks} blocks but mesh axis {axis!r} has "
            f"{size} devices; the sharded head wants exactly one block per "
            f"device (erasure = dropping a device's output)"
        )


def shard_coded_head(w_coded: torch.Tensor, mesh: HeadMesh) -> tuple[torch.Tensor, ...]:
    """Place the coded head [n_blocks*br, in] on the mesh: block i on
    ``mesh.devices[i]``.  The counterpart of ``coded_head_sharding`` and the
    ``device_put`` after it.  A block whose device is the weight's own is a
    view, not a copy, so on one card the placement adds no memory."""
    n_blocks = len(mesh.devices)
    if w_coded.dim() != 2 or w_coded.shape[0] % n_blocks:
        raise ValueError(
            f"coded head {tuple(w_coded.shape)} does not split into {n_blocks} row blocks")
    return tuple(blk if dev == blk.device else blk.to(dev)
                 for blk, dev in zip(w_coded.chunk(n_blocks), mesh.devices))
