"""Kernel-mode, macro-step and head-mesh contexts (port of ``repro.sharding.ctx``).

Model code reads these where its caller passed nothing: the coded head's
kernel mode (``head_kernel_mode``; ``'auto'`` turns on the per-shape
dispatch of ``repro_torch.kernels.dispatch``), the fused macro-step length
K of the block being captured (``macro_step_k``; ``'auto'`` drops
candidates a CUDA graph cannot hold and amortizes the dispatch floor over
K) and the head mesh (``coded_head_mesh``).  An explicit argument always
wins over a context: the port's ``head_kernel_mode=`` and ``head_mesh=``
keep their meaning.  Each context is a no-op on None, so callers thread an
optional value straight in.  The reference's ``sharding_hints`` /
``shard_hint`` are not ported: one card has no layout to constrain, and no
port code would call them.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

__all__ = [
    "coded_head_mesh",
    "current_coded_head_mesh",
    "current_head_kernel_mode",
    "current_macro_step_k",
    "head_kernel_mode",
    "macro_step_k",
]

# (HeadMesh, axis) the coded LM head runs on, one code block per device
_CODED_HEAD: ContextVar[tuple | None] = ContextVar("coded_head_mesh", default=None)
# kernel mode of the coded LM-head matvec; None keeps the default path
_HEAD_KMODE: ContextVar[str | None] = ContextVar("head_kernel_mode", default=None)
# fused macro-step length K of the block being built; 1 is the scalar step
_MACRO_K: ContextVar[int] = ContextVar("macro_step_k", default=1)


def current_coded_head_mesh() -> tuple | None:
    """(HeadMesh, axis name) for the mesh-sharded coded head, or None."""
    return _CODED_HEAD.get()


@contextlib.contextmanager
def coded_head_mesh(mesh, axis: str | None = None):
    """Run the coded LM-head matvec on ``mesh`` (a
    ``repro_torch.sharding.HeadMesh``), one code block per device, along
    ``axis`` (default: the mesh's own).  A None mesh is a no-op."""
    if mesh is None:
        yield
        return
    token = _CODED_HEAD.set((mesh, mesh.axis if axis is None else axis))
    try:
        yield
    finally:
        _CODED_HEAD.reset(token)


def current_head_kernel_mode() -> str | None:
    """Kernel mode for the coded LM-head matvec, or None (default path)."""
    return _HEAD_KMODE.get()


@contextlib.contextmanager
def head_kernel_mode(mode: str | None):
    """Run the coded LM-head matvec with ``kernel_mode=mode``: ``'auto'``
    for the per-shape dispatch, an explicit mode to pin one.  None is a
    no-op."""
    if mode is None:
        yield
        return
    token = _HEAD_KMODE.set(mode)
    try:
        yield
    finally:
        _HEAD_KMODE.reset(token)


def current_macro_step_k() -> int:
    """Fused macro-step length of the block being built (1 = scalar)."""
    return _MACRO_K.get()


@contextlib.contextmanager
def macro_step_k(k: int | None):
    """Declare that the enclosed calls build a block of ``k`` fused decode
    steps (on the card, one CUDA graph), so ``'auto'`` dispatch ranks
    candidates for it.  None or ``k <= 1`` is a no-op."""
    if k is None or k <= 1:
        yield
        return
    token = _MACRO_K.set(int(k))
    try:
        yield
    finally:
        _MACRO_K.reset(token)
