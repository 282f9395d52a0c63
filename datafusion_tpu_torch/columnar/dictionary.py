"""Host-side sorted string dictionaries.

TPU-native string strategy (SURVEY.md §7): device buffers hold int32
dictionary codes; the dictionary of distinct strings lives on the host.  The
dictionary is kept SORTED so codes are order-isomorphic to the strings —
string comparisons, ORDER BY, and MIN/MAX on strings become integer ops on
codes.  String *compute* (LIKE, substr, upper, ...) runs host-side once per
distinct value and is shipped to the device as a code-indexed lookup table
(a gather), never as per-row string work.

Replaces the reference's Utf8 Arrow arrays + per-row string kernels
(datafusion/src/physical_plan/string_expressions.rs).
"""

from __future__ import annotations

import itertools

import numpy as np

_ids = itertools.count()


class StringDict:
    """An immutable sorted array of distinct strings.

    ``values``: np.ndarray of dtype object/str, sorted ascending, unique.
    Code ``i`` represents ``values[i]``; validity is tracked separately in the
    column, so there is no sentinel code.
    """

    __slots__ = ("values", "_lookup", "_id", "_value_hash_lut")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)
        self._lookup: dict[str, int] | None = None
        self._id = next(_ids)

    # identity-based hash/eq: dictionaries are immutable; jit-cache keys use
    # identity so repeated queries over the same table hit the cache.
    def __hash__(self) -> int:
        return self._id

    def __eq__(self, other) -> bool:
        return self is other

    def __len__(self) -> int:
        return len(self.values)

    def __repr__(self) -> str:
        return f"StringDict({len(self.values)} values)"

    @staticmethod
    def empty() -> "StringDict":
        return StringDict(np.array([], dtype=object))

    @staticmethod
    def from_strings(strings) -> tuple["StringDict", np.ndarray]:
        """Build a sorted dict from raw values; returns (dict, codes).

        ``strings`` may contain None; those get code 0 (masked by validity).
        """
        d, codes, _ = StringDict.from_strings_masked(strings)
        return d, codes

    @staticmethod
    def from_strings_masked(
        strings,
    ) -> tuple["StringDict", np.ndarray, np.ndarray]:
        """(dict, codes, valid) via hash-based factorization.

        O(n) C-speed hashing (pandas factorize) + an O(k log k) sort of the
        k DISTINCT values only — never a sort or fixed-width unicode copy of
        all n rows (that path was minutes + ~10 GB at a 60M-row SF10
        lineitem ingest)."""
        import pandas as pd

        arr = np.asarray(strings, dtype=object)
        inv, uniques = pd.factorize(arr, use_na_sentinel=True)
        uniq = np.asarray(uniques, dtype=object)
        valid = inv >= 0
        codes = np.zeros(len(arr), dtype=np.int32)
        if len(uniq):
            order = np.argsort(uniq.astype(str), kind="stable")
            rank = np.empty(len(uniq), dtype=np.int32)
            rank[order] = np.arange(len(uniq), dtype=np.int32)
            codes[valid] = rank[inv[valid]]
            uniq = uniq[order]
        return StringDict(uniq), codes, valid

    def _table(self) -> dict[str, int]:
        if self._lookup is None:
            self._lookup = {s: i for i, s in enumerate(self.values)}
        return self._lookup

    def code_of(self, s: str) -> int | None:
        """Exact-match code, or None if absent."""
        return self._table().get(s)

    def searchsorted(self, s: str, side: str = "left") -> int:
        """Insertion point of ``s`` — enables range comparisons vs literals
        even when the literal is not in the dictionary."""
        return int(np.searchsorted(self.values.astype(str), s, side=side))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """The strings of ``codes`` as an object array; codes out of range
        (those of null rows) are clipped into it."""
        if not len(self.values):
            return np.full(len(codes), None, dtype=object)
        return self.values.take(np.clip(codes, 0, len(self.values) - 1))

    def map_values(self, fn) -> tuple["StringDict", np.ndarray]:
        """Apply a str->str function per distinct value; returns
        (new sorted dict, remap) with remap[old_code] = new_code."""
        if len(self.values) == 0:
            return StringDict.empty(), np.zeros(0, dtype=np.int32)
        mapped = np.array([fn(s) for s in self.values], dtype=object)
        uniq, inv = np.unique(mapped.astype(str), return_inverse=True)
        return StringDict(uniq.astype(object)), inv.astype(np.int32)

    def predicate_lut(self, fn) -> np.ndarray:
        """Boolean LUT over codes for a str->bool predicate (LIKE etc.)."""
        return np.array([bool(fn(s)) for s in self.values], dtype=bool)

    @staticmethod
    def merge(a: "StringDict", b: "StringDict") -> tuple["StringDict", np.ndarray, np.ndarray]:
        """Merge two sorted dicts; returns (merged, remap_a, remap_b).

        Used to harmonize two string columns before a cross-column compare /
        join / union (host-side bind step; device work is one gather).
        Memoized by input identity: repeated queries then produce the SAME
        merged dictionary object, keeping downstream jit-cache keys (which
        include dictionary identities) stable across executions."""
        if a is b:
            n = len(a)
            ident = np.arange(n, dtype=np.int32)
            return a, ident, ident
        key = (a._id, b._id)
        cached = _MERGE_CACHE.get(key)
        if cached is not None:
            return cached
        union = np.unique(
            np.concatenate([a.values.astype(str), b.values.astype(str)])
        )
        merged = StringDict(union.astype(object))
        remap_a = np.searchsorted(union, a.values.astype(str)).astype(np.int32)
        remap_b = np.searchsorted(union, b.values.astype(str)).astype(np.int32)
        if len(_MERGE_CACHE) > 4096:
            _MERGE_CACHE.clear()
        _MERGE_CACHE[key] = (merged, remap_a, remap_b)
        return merged, remap_a, remap_b


_MERGE_CACHE: dict = {}
