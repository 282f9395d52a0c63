"""Inputs of ``ops/take.py::take`` (kernel K2) and the per-column form it
replaced, written in numpy: read by the CPU test of the plain version
(``test_torch_kernels.py``) and the card's test of the kernel
(``test_torch_gpu.py``).  Imports no JAX.

A case is ``make(rng, device) -> (datas, valids, idx, mask, sel)``, the
same values on every device for one seed; ``expected`` computes each
output the way the call sites did before K2: per buffer one gather, the
index clamped at 0, each mask gathered and ANDed with the row mask and
``idx >= 0``.
"""

from __future__ import annotations

import numpy as np
import torch

CAP = 1000  # source rows
N = 777  # output rows: odd, so the last pair of rows is ragged

_INT_DTYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64")


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def random_bits(rng, dtype: str, shape) -> np.ndarray:
    """Values of every bit pattern of ``dtype``: floats include -0.0, NaNs
    with payloads and infinities."""
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.random(shape) > 0.5
    bits = rng.integers(0, 256, size=tuple(np.atleast_1d(shape)) + (dt.itemsize,), dtype=np.uint8)
    out = bits.view(dt).reshape(shape).copy()
    if dt.kind == "f":
        flat = out.reshape(-1)
        flat[::7] = -0.0
        flat[3::11] = np.nan
        flat[5::13] = -np.inf
    return out


def _valid(rng, dev, cap=CAP):
    return _t(rng.random(cap) > 0.2, dev)


def _index(rng, dev, n=N, cap=CAP, negative=False):
    return _t(rng.integers(-1 if negative else 0, cap, n).astype(np.int64), dev)


def _dtype_case(dtype):
    def make(rng, dev):
        data = _t(random_bits(rng, dtype, CAP), dev)
        return (data,), (_valid(rng, dev),), _index(rng, dev), _t(rng.random(N) > 0.1, dev), None
    return make


def _list_case(rng, dev):
    a = _t(rng.integers(-(10**12), 10**12, (CAP, 3)), dev)
    b = _t(random_bits(rng, "int16", (CAP, 5)), dev)  # 10-byte rows: moved 2 bytes at a time
    return (a, b), (_valid(rng, dev), _valid(rng, dev)), _index(rng, dev), None, None


def _negative_case(rng, dev):
    datas = (_t(random_bits(rng, "int64", CAP), dev), _t(random_bits(rng, "float32", CAP), dev))
    mask = _t(rng.random(N) > 0.1, dev)
    return datas, (_valid(rng, dev), _valid(rng, dev)), _index(rng, dev, negative=True), mask, None


def _composed_case(rng, dev):
    """An outer index: row i takes idx[sel[i]] (a join's ``li[sel]``)."""
    inner = _index(rng, dev, n=2 * N, negative=True)
    sel = _t(rng.integers(0, 2 * N, N).astype(np.int64), dev)
    datas = tuple(_t(random_bits(rng, d, CAP), dev) for d in ("int32", "uint64", "bool"))
    return datas, (_valid(rng, dev),) * 3, inner, _t(rng.random(N) > 0.1, dev), sel


def _empty_case(rng, dev):
    datas = (_t(random_bits(rng, "int64", CAP), dev),)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    return datas, (_valid(rng, dev),), empty, empty.to(torch.bool), None


def _no_columns_case(rng, dev):
    return (), (), _index(rng, dev), None, None


def _int32_index_case(rng, dev):
    datas = (_t(random_bits(rng, "int64", CAP), dev), _t(random_bits(rng, "uint8", CAP), dev))
    return datas, (_valid(rng, dev),), _index(rng, dev, negative=True).to(torch.int32), None, None


def _views_case(rng, dev):
    """Sources that are views: an odd offset (unaligned rows), a row
    broadcast by a zero stride, a 0-dim row mask; keys only, no masks."""
    base = _t(random_bits(rng, "int64", CAP + 1), dev)
    one = _t(random_bits(rng, "float64", 1), dev)
    datas = (base[1:], one.expand(CAP), _t(random_bits(rng, "int32", CAP + 1), dev)[1:])
    one_mask = torch.tensor(True, device=dev)
    return datas, (_valid(rng, dev)[:1].expand(CAP),), _index(rng, dev), one_mask, None


def _monotone_case(rng, dev):
    """A compaction's permutation: rising within the live rows."""
    keep = rng.random(CAP) > 0.4
    perm = np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)])[:N]
    datas = tuple(_t(random_bits(rng, d, CAP), dev) for d in ("int64", "int32", "float64", "int8"))
    live = _t(np.arange(N) < keep.sum(), dev)
    return datas, tuple(_valid(rng, dev) for _ in datas), _t(perm.astype(np.int64), dev), live, None


def wide_case(rng, dev, ncols: int = 40, cap: int = CAP, n: int = N):
    """More buffers than one launch takes (``MAX_ITEMS``): ``ncols`` data
    columns of every width and their masks."""
    kinds = ("int64", "int32", "float64", "uint16", "int8", "bool", "uint64", "float32")
    datas = tuple(_t(random_bits(rng, kinds[i % len(kinds)], cap), dev) for i in range(ncols))
    valids = tuple(_valid(rng, dev, cap) for _ in range(ncols))
    return datas, valids, _index(rng, dev, n, cap, negative=True), _t(rng.random(n) > 0.1, dev), None


TAKE_CASES = {
    **{d: _dtype_case(d) for d in (*_INT_DTYPES, "float32", "float64", "bool")},
    "list-columns": _list_case,
    "negative-index": _negative_case,
    "outer-index": _composed_case,
    "empty-index": _empty_case,
    "no-columns": _no_columns_case,
    "int32-index": _int32_index_case,
    "views": _views_case,
    "monotone": _monotone_case,
    "wide": wide_case,
}


def _bits(x: np.ndarray) -> np.ndarray:
    """The bytes of x, row by row: equal arrays of floats have equal NaNs."""
    x = np.ascontiguousarray(x)
    return x.view(np.uint8).reshape(x.shape[0], -1) if x.size else x.reshape(x.shape[0], 0)


def expected(datas, valids, idx, mask, sel):
    """The per-column form the call sites had, in numpy: (datas, valids)."""
    i = idx.cpu().numpy().astype(np.int64)
    if sel is not None:
        i = i[sel.cpu().numpy()]
    hit = i >= 0
    if mask is not None:
        hit = hit & np.broadcast_to(mask.cpu().numpy(), hit.shape)
    j = np.maximum(i, 0)
    return [d.cpu().numpy()[j] for d in datas], [v.cpu().numpy()[j] & hit for v in valids]


def assert_same(got, want) -> None:
    """Every output equal to its expected bytes, shape and dtype."""
    (gd, gv), (wd, wv) = got, want
    assert len(gd) == len(wd) and len(gv) == len(wv)
    for g, w in zip(list(gd) + list(gv), list(wd) + list(wv)):
        g = g.cpu()
        w = torch.as_tensor(np.ascontiguousarray(w)) if isinstance(w, np.ndarray) else w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
