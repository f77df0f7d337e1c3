"""Hand-written Hopper kernels, their plain PyTorch versions and mode-switching wrappers."""
from __future__ import annotations

import os
import re
import tempfile
import warnings

# substrings of each kernel's symbols (one an engine), by kernel name: what
# names the kernel's nodes in a captured CUDA graph
_SYMBOLS = {"coded_matvec": ("MatvecTask",),
            "coded_matvec_decode": ("DecodeTask",),
            "gaussian_encode": ("gaussian_encode_kernel", "WideGaussianTask"),
            "lt_encode": ("lt_encode_kernel", "lt_slab_kernel"),
            "masked_pinv": ("masked_pinv_kernel",),
            "ssd_chunk": ("ssd_chunk_",),
            "ssd_combine": ("ssd_combine_",)}
# what names the wide engine's kernel (csrc/wide_rows.cuh), beside the
# head kernels' own symbols above
_WIDE_SYMBOL = "wide_rows_kernel"
_WIDE_KERNELS = ("coded_matvec", "coded_matvec_decode")
_NODE = re.compile(r'^\s*"?graph_\d+_node_\d+"?\s*\[', re.M)


def kernel_wrappers() -> dict:
    """Each hand-written kernel's wrapper, by kernel name.  A wrapper adds
    one to its ``.launches`` where it launches its kernel (``count_launch``);
    the serving engine adds a captured CUDA graph's kernel nodes on each
    replay."""
    from repro_torch.kernels.coded_decode import coded_matvec_decode_cuda
    from repro_torch.kernels.coded_matvec import coded_matvec_cuda
    from repro_torch.kernels.lt_encode import gaussian_encode_cuda, lt_encode_cuda
    from repro_torch.kernels.masked_pinv import masked_pinv_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda, ssd_combine_cuda

    return {"coded_matvec": coded_matvec_cuda,
            "coded_matvec_decode": coded_matvec_decode_cuda,
            "gaussian_encode": gaussian_encode_cuda,
            "lt_encode": lt_encode_cuda,
            "masked_pinv": masked_pinv_cuda,
            "ssd_chunk": ssd_chunk_cuda,
            "ssd_combine": ssd_combine_cuda}


def refuse_grad(wrapper, *tensors) -> None:
    """Raise if ``wrapper``'s kernel would drop a gradient: grad mode is on
    and an input requires grad.  A kernel writes into plain output tensors
    with no ``grad_fn``, so the product would be cut out of the graph
    silently; a path that trains goes through an autograd Function instead
    (``kernels.ops.SSDScan`` for the SSD)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper.__name__} got an input that requires grad under grad mode: the "
            f"kernel has no backward; call it under torch.no_grad() or through an "
            f"autograd Function")


def count_launch(wrapper, engine: str | None = None) -> None:
    """Count one call of ``wrapper``'s C entry on the current stream.  While
    that stream captures a CUDA graph nothing launches: the kernel is
    recorded into the graph and goes to ``wrapper.captured``; it runs, and
    is counted, at each replay.  ``engine``: the call launched a second
    engine of the kernel, also counted in ``wrapper.<engine>_launches``
    (``<engine>_captured``): ``'wide'``, the tensor-core engine of the head
    kernels (x of ``WIDE_MIN_B`` columns and more) and of
    ``gaussian_encode`` (q over ``GAUSSIAN_WIDE_MIN_Q`` rows); ``'slab'``,
    ``lt_encode``'s shared-memory slab engine."""
    import torch

    kind = "captured" if torch.cuda.is_current_stream_capturing() else "launches"
    setattr(wrapper, kind, getattr(wrapper, kind) + 1)
    if engine is not None:
        name = f"{engine}_{kind}"
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def graph_kernel_nodes(graph) -> dict[str, int]:
    """The kernel nodes of each hand-written kernel in a captured
    ``torch.cuda.CUDAGraph``, by kernel name, read from the graph itself
    (CUDA's DOT dump of it).  The graph must have been made with
    ``keep_graph=True``, which keeps the captured graph to dump."""
    return count_kernel_nodes(graph_dot(graph))


def graph_dot(graph) -> str:
    """CUDA's DOT dump of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``."""
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.filterwarnings("ignore", "DEBUG: calling", UserWarning)  # the dump's notices
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError("the CUDA graph was not dumped: make it with keep_graph=True")
        with open(path) as f:
            return f.read()


def _dot_nodes(dot: str) -> list[str]:
    starts = [m.start() for m in _NODE.finditer(dot)]
    if not starts:
        raise ValueError("no graph node in the DOT text")
    return [dot[a:b] for a, b in zip(starts, starts[1:] + [len(dot)])]


def count_kernel_nodes(dot: str) -> dict[str, int]:
    """Count, in a CUDA graph's DOT text, the nodes whose label names each
    kernel's symbol; a node is counted once however often its label names
    it (mangled and demangled)."""
    nodes = _dot_nodes(dot)
    return {name: sum(any(sym in node for sym in syms) for node in nodes)
            for name, syms in _SYMBOLS.items()}


def count_wide_nodes(dot: str) -> dict[str, int]:
    """Count, in a CUDA graph's DOT text, each head kernel's nodes that are
    the wide engine's (their label names both symbols)."""
    nodes = _dot_nodes(dot)
    return {name: sum(_SYMBOLS[name][0] in node and _WIDE_SYMBOL in node for node in nodes)
            for name in _WIDE_KERNELS}
