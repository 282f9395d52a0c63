"""What the window queries' reference modules (``w1`` .. ``w4``, ``r1``)
share: a lexicographic sort, the runs of equal sorted keys, and the cut
of a timed form.

Each window module gives ``full(x)``, the full form's columns and a NULL
mask per column (None where the column has no NULL), and ``run(x)``, the
timed form: ``cut`` applies its filter and ORDER BY on the device and
hands over only the rows its LIMIT keeps, and every further row tied with
the last of them on all ORDER BY columns, so the pure-Python comparison
reads at most a few hundred rows of a 60 M-row form.  Plain torch;
imports nothing of the port.
"""

from __future__ import annotations

import torch


def lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the rows by ``keys``, the first the most
    significant, each ascending (stable sorts from the last key)."""
    perm = torch.arange(len(keys[0]), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def runs(*sorted_keys: torch.Tensor):
    """(run, first, last): each sorted row's run of equal keys (numbered
    from 0), and the first and last row of that run."""
    n = len(sorted_keys[0])
    new = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    new[:1] = True
    for k in sorted_keys:
        new[1:] |= k[1:] != k[:-1]
    run = torch.cumsum(new.to(torch.int64), 0) - 1
    first = torch.searchsorted(run, run)
    last = torch.searchsorted(run, run, right=True) - 1
    return run, first, last


def cut(values: list, keep, order: list, limit: int) -> list:
    """The timed form's rows of the full form's ``values``: those where
    ``keep`` holds (all when None), sorted by the ``order`` columns
    (tensors, ascending), the first ``limit`` and every row after them
    tied with the last on all of ``order``."""
    idx = torch.arange(len(order[0]), device=order[0].device)
    if keep is not None:
        idx = idx[keep]
    idx = idx[lexsort(*(o[idx] for o in order))]
    n = min(limit, len(idx))
    if 0 < n < len(idx):
        tied = torch.ones(len(idx) - n, dtype=torch.bool, device=idx.device)
        for o in order:
            tied &= o[idx[n:]] == o[idx[n - 1]]
        # ties with the last kept row follow it in the sort
        n += int(torch.cumprod(tied.to(torch.int64), 0).sum())
    return [v[idx[:n]] for v in values]
