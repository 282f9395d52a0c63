"""Inputs at which kernel K1 (``ops/smalldomain.py``) is held exactly
against its plain version on the card: ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` both run every case of ``K1_CASES``.

Each case is ``make(rng) -> (gid, cols, masks, domain)`` with the tensors
on the CUDA card, drawn from a numpy ``Generator``.  Besides TPC-H Q1's
shape, the cases reach every path of the kernel through its inputs alone:
each count of cell copies (32 down to 2, chosen from domain x columns),
row-by-row loads (unaligned inputs, a ragged last step), dead rows and
steps, shared tensors, and sums that wrap.
"""

from __future__ import annotations

import numpy as np
import torch


def k1_inputs(rng, n, domain, k, lo, hi, dead_frac=0.05, none_vals=(), none_masks=()):
    """k random int64 columns in [lo, hi) with random masks (10 % invalid),
    group ids uniform over the domain, ``dead_frac`` of the rows dead;
    ``none_vals``/``none_masks``: the items without values or masks."""
    dev = torch.device("cuda")
    gid = rng.integers(0, domain, n).astype(np.int32)
    gid[rng.random(n) < dead_frac] = domain  # dead rows
    cols, masks = [], []
    for j in range(k):
        cols.append(None if j in none_vals else
                    torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64)).to(dev))
        masks.append(None if j in none_masks else
                     torch.from_numpy(rng.random(n) > 0.1).to(dev))
    return torch.from_numpy(gid).to(dev), cols, masks, domain


def with_gid(args, gid):
    """The same columns under other group ids (a numpy array)."""
    return (torch.from_numpy(gid.astype(np.int32)).to(args[0].device), *args[1:])


def duplicate_pointers(rng):
    """Items that share tensors, as Q1's sum and avg of one column do."""
    gid, c, m, domain = k1_inputs(rng, 1 << 20, 12, 3, -(10**12), 10**12)
    return gid, [c[0], c[0], c[1], c[1], c[2], None, c[0]], [m[0], m[0], m[0], None, m[1], None, m[2]], domain


def misaligned(rng):
    """Columns and masks that start one element into their storage: the
    kernel loads them row by row instead of 16 bytes at a time."""
    gid, c, m, domain = k1_inputs(rng, (1 << 20) + 1, 9, 3, -(10**9), 10**9, none_masks=(2,))
    return gid[1:], [x[1:] for x in c], [None if x is None else x[1:] for x in m], domain


def rows(n):
    return np.arange(n, dtype=np.int64)


def eight_items(domain):
    """8 distinct masked items: 8 sum and 8 count columns, 24 words of cells
    a slot, so 48 KB holds 32 copies up to 16 slots, 16 up to 32, 8 up to
    64, 4 up to 128 and 2 up to 256."""
    return lambda rng: k1_inputs(rng, 1 << 20, domain, 8, -(10**12), 10**12)


K1_CASES = {
    "q1-sf1-shape": lambda rng: k1_inputs(rng, 8_388_608, 12, 8, 0, 1_050_000_000,
                                          none_vals=(7,), none_masks=(7,)),
    "domain256": lambda rng: k1_inputs(rng, 1 << 20, 256, 8, -(10**14), 10**14,
                                       none_vals=(2,), none_masks=(5,)),
    "wrapping": lambda rng: k1_inputs(rng, 1 << 20, 5, 3, (1 << 62) - 1000, 1 << 62),
    "wrapping-negative": lambda rng: k1_inputs(rng, 1 << 20, 5, 2, -(1 << 62), -(1 << 62) + 1000),
    "n-not-block-multiple": lambda rng: k1_inputs(rng, 1_000_003, 7, 4, -1000, 1000),
    "all-dead": lambda rng: with_gid(k1_inputs(rng, 65_536, 4, 1, 0, 10), np.full(65_536, 9)),
    "duplicate-pointers": duplicate_pointers,
    "every-mask-null": lambda rng: k1_inputs(rng, 1 << 20, 12, 6, -(10**9), 10**9,
                                             none_vals=(5,), none_masks=range(6)),
    "one-group": lambda rng: with_gid(k1_inputs(rng, 1 << 20, 12, 8, -(10**15), 10**15),
                                      np.where(rows(1 << 20) % 101 == 0, 12, 3)),
    "one-group-2-copies": lambda rng: with_gid(eight_items(256)(rng),
                                               np.where(rows(1 << 20) % 101 == 0, 256, 3)),
    "gid-row-mod-32": lambda rng: with_gid(k1_inputs(rng, 1 << 20, 40, 4, -(10**9), 10**9),
                                           rows(1 << 20) % 32),
    "32-groups-a-warp-row": lambda rng: with_gid(k1_inputs(rng, 1 << 20, 40, 4, -(10**9), 10**9),
                                                 rows(1 << 20) // 4 % 32 + 3),
    "32-copies-at-limit": eight_items(16),
    "16-copies": eight_items(17),
    "8-copies-at-limit": eight_items(64),
    "4-copies": eight_items(65),
    "2-copies": eight_items(256),
    "n-3": lambda rng: k1_inputs(rng, 3, 2, 2, -5, 5, dead_frac=0.0),
    "negative-gids": lambda rng: with_gid(k1_inputs(rng, 1_000_003, 10, 3, -(10**9), 10**9),
                                          rng.integers(-7, 13, 1_000_003)),
    "wrapping-both-signs": lambda rng: k1_inputs(rng, 1 << 20, 3, 2, -(1 << 62), 1 << 62),
    "misaligned": misaligned,
}
