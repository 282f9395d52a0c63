"""Move the rows of many columns and their validity masks by one index
(kernel K2).

``take`` is how the port moves a table's rows: a join's output sides, a
compaction, the sort path of a GROUP BY, a sort's payloads, windows.  Row
i of every output takes source row ``idx[i]`` (``idx[sel[i]]`` with an
outer index ``sel``), and every validity mask is also ANDed with the
row mask ``mask[i]``.  The null rule: a negative index gives a NULL row,
its data read at row 0 and its valid bit cleared (outer joins pad with
-1).

On a CUDA tensor it launches the hand-written kernel in ``csrc/take.cu``
(design notes there), up to ``MAX_ITEMS`` buffers a launch; on a CPU
tensor it runs the plain PyTorch version, ``take_plain``, one index
kernel per buffer and an AND per mask.  It replaces no TPU kernel: the
reference's gathers were ``jnp`` gathers that XLA fused, and the card's
profile named PyTorch's per-column index kernel its largest cost.

What bounds the kernel is bytes: the index once, each buffer's rows at
the source (a 32-byte sector per row where the index scatters them),
each output row once.  The kernel never looks at a dtype: it moves rows
of any width in bytes, so list columns ``[capacity, k]`` and the
unsigned storages need no signed view.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from .. import tracing
from ..device import capturing

MAX_ITEMS = 32  # buffers a launch (csrc/take.cu kMaxItems)


def take(datas, valids, idx: torch.Tensor, mask: torch.Tensor | None = None,
         sel: torch.Tensor | None = None):
    """(the rows ``idx`` of each of ``datas``, of each of ``valids`` ANDed
    with ``mask``), under the null rule; with ``sel``, the rows
    ``idx[sel]`` without building that vector.

    datas  : tensors [cap, ...] of any dtype (rows of any width)
    valids : bool tensors [cap] (validity masks)
    idx    : [m] int64 or int32 row numbers (negative: NULL)
    mask   : bool [n] or a 0-dim bool, ANDed into every output mask
    sel    : [n] int64 rows of ``idx``, none negative
    Returns (tuple of [n, ...] datas, tuple of [n] bool masks), n the
    length of ``sel`` or else of ``idx``.

    On CUDA tensors this launches the kernel or raises; it never falls
    back to the plain version.  ``take.launches`` counts the launches it
    makes (a wide table takes several); a launch recorded into a CUDA
    graph is not one, and a replay of the graph runs the kernel without
    calling this wrapper.  The tracer counts ``dftpu.take`` once per call
    that moves rows, outside a capture, on every device."""
    datas, valids = tuple(datas), tuple(valids)
    n = (idx if sel is None else sel).shape[0]
    if n and (datas or valids) and not capturing():
        tracing.count("dftpu.take")
    if idx.device.type == "cpu":
        return take_plain(datas, valids, idx, mask, sel)
    dev = idx.device
    idx, sel, mask = _check_cuda_args(datas, valids, idx, mask, sel, n)
    out_d = tuple(torch.empty((n,) + tuple(d.shape[1:]), dtype=d.dtype, device=dev) for d in datas)
    out_v = tuple(torch.empty(n, dtype=torch.bool, device=dev) for _ in valids)
    if n == 0:
        return out_d, out_v
    items = [_item(d, o, False) for d, o in zip(datas, out_d)]
    items += [_item(v, o, True) for v, o in zip(valids, out_v)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    mask_ptr = None if mask is None else mask.data_ptr()
    mask_stride = 0 if mask is None else mask.stride(0)
    sel_ptr = None if sel is None else sel.data_ptr()
    launches = 0
    for lo in range(0, len(items), MAX_ITEMS):
        chunk = items[lo:lo + MAX_ITEMS]
        err = _launcher()(
            (_Item * len(chunk))(*chunk), len(chunk), idx.data_ptr(), idx.element_size(),
            sel_ptr, mask_ptr, mask_stride, n, stream,
        )
        if err != 0:
            raise RuntimeError(f"take launch failed: CUDA error {err}")
        launches += 1
    if not capturing():
        # the executor threads of a distributed context launch concurrently
        with _LAUNCHES_LOCK:
            take.launches += launches
    return out_d, out_v


take.launches = 0
_LAUNCHES_LOCK = threading.Lock()


class _Item(ctypes.Structure):
    """One buffer of a launch (csrc/take.cu ``TakeItem``)."""

    _fields_ = [
        ("src", ctypes.c_void_p),
        ("dst", ctypes.c_void_p),
        ("stride", ctypes.c_longlong),  # source bytes between rows (0: broadcast)
        ("width", ctypes.c_int),  # bytes a row
        ("masked", ctypes.c_int),  # a validity mask
    ]


def _item(src: torch.Tensor, dst: torch.Tensor, masked: bool) -> _Item:
    size = src.element_size()
    return _Item(src.data_ptr(), dst.data_ptr(), src.stride(0) * size,
                 size * math.prod(src.shape[1:]), int(masked))


@functools.cache
def _launcher():
    """The kernel's C launcher (built on first use), its signature set."""
    from ..build import load

    fn = load("take").take_launch
    fn.argtypes = [
        ctypes.POINTER(_Item),  # items
        ctypes.c_int,  # nitems
        ctypes.c_void_p,  # idx
        ctypes.c_int,  # idx_bytes
        ctypes.c_void_p,  # sel
        ctypes.c_void_p,  # mask
        ctypes.c_longlong,  # mask_stride
        ctypes.c_longlong,  # n
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether each row of t is one run of bytes (the rows themselves may
    lie at any stride, 0 included)."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return False
        step *= size
    return True


def _check_cuda_args(datas, valids, idx, mask, sel, n):
    """The arguments as the kernel takes them; raises on what it does not."""
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"take: unsupported device {dev}")
    if idx.dim() != 1 or idx.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"take: idx must be a [m] int64 or int32 tensor, got "
                         f"{list(idx.shape)} {idx.dtype}")
    idx = idx.contiguous()
    if sel is not None:
        if sel.device != dev or sel.dim() != 1 or sel.dtype != torch.int64:
            raise ValueError(f"take: sel must be a [n] int64 tensor on {dev}")
        sel = sel.contiguous()
    if mask is not None:
        if mask.device != dev or mask.dtype != torch.bool or mask.dim() > 1:
            raise ValueError(f"take: mask must be a bool tensor on {dev}")
        mask = mask.expand(n)
    for d in datas:
        if d.device != dev or d.dim() < 1:
            raise ValueError(f"take: a data buffer on {d.device} of shape {list(d.shape)}")
        if not _rows_contiguous(d):
            raise ValueError(f"take: a data buffer's rows are not contiguous (strides {d.stride()})")
    for v in valids:
        if v.device != dev or v.dtype != torch.bool or v.dim() != 1:
            raise ValueError(f"take: a validity mask must be a [cap] bool tensor on {dev}")
    return idx, sel, mask


def take_plain(datas, valids, idx, mask=None, sel=None):
    """Plain PyTorch version: one gather per buffer (``kernels.gather``),
    the null rule by a clamp and a comparison, and an AND per mask."""
    from .kernels import gather

    if sel is not None:
        idx = idx[sel]
    if valids:
        hit = idx >= 0
        if mask is not None:
            hit = hit & mask
    j = torch.clamp(idx, min=0)
    return tuple(gather(d, j) for d in datas), tuple(v[j] & hit for v in valids)
