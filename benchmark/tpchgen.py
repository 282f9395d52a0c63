"""TPC-H's eight tables at any scale factor, made from a seed.

A frozen copy of the port's generator (``tpchdata.generate_tpch``, itself
a copy of the JAX package's dbgen approximation), with TPC-H's schema and
value domains, rewritten to draw every column in bulk on a device with a
``torch.Generator`` and to give each string column as int32 codes into a
sorted vocabulary, so no Python loop runs per row.  It departs from that
generator where bulk drawing needs it, and the configurations' files list
each departure under ``assumed``:

* money is drawn in whole cents (the same domains: ``c_acctbal`` from
  -999.99 to 9,999.99, ``o_totalprice`` from 1,000.00 to 500,000.00,
  ``ps_supplycost`` from 1.00 to 1,000.00);
* comments, addresses and part names are drawn from pools of up to 65,536
  strings of the generator's words (the port's generator pools them above
  65,536 rows too), and a supplier comment gains " Customer Complaints"
  with probability 1/100;
* phone numbers keep the format ``CC-NNN-NNN-NNNN`` with the country code
  ``10 + nationkey``, the local part drawn from a pool of 4,096;
* lineitem has the same number of rows for every seed, dbgen's count at
  SF10 (59,986,052) scaled by the orders: each order still draws 1 to 7
  lines, and then randomly chosen orders gain or lose one line until the
  total is that count.  A count that moved with the seed would move the
  port's join order (``optimizer/hash_build_probe_order.py`` compares row
  estimates, and lineitem's falls on orders' at 4 lines per order), and
  with it the work of every run.

Keys are dense as in the port's generator: ``o_orderkey = 4i - 3`` for
order i, every other key runs 1..n.  The same ``(sf, seed)`` on the same
kind of device gives the same tables.  Imports nothing of the port: the
plain reference reads these arrays too.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COMMENT_WORDS = [
    "carefully", "quickly", "express", "special", "requests", "deposits",
    "packages", "furiously", "ironic", "regular", "pending", "final",
    "accounts", "theodolites", "instructions", "foxes", "dependencies",
    "platelets", "accounts", "waters", "customer", "complaints", "unusual",
]
COLORS = [
    "moccasin", "thistle", "powder", "lavender", "sienna", "indian",
    "linen", "honeydew", "navajo", "lace", "cornflower", "almond",
    "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "green", "forest", "chartreuse", "ivory", "khaki", "lemon",
    "magenta", "maroon", "olive", "orange", "pink", "plum", "red",
    "rose", "salmon", "sandy", "seashell", "sky", "slate", "smoke",
    "snow", "spring", "steel", "tan", "tomato", "turquoise", "violet",
    "wheat", "white", "yellow",
]

POOL = 1 << 16
PHONE_POOL = 1 << 12
# dbgen's lineitem rows at SF10, for its 15,000,000 orders
DBGEN_SF10_LINEITEM, DBGEN_SF10_ORDERS = 59_986_052, 15_000_000

# column kinds: int64, decimal (int64 cents, decimal(15,2)), date (int32
# days since 1970-01-01), string (int32 codes into ``TpchData.vocab``)
SCHEMA = {
    "region": [("r_regionkey", "int64"), ("r_name", "string"), ("r_comment", "string")],
    "nation": [("n_nationkey", "int64"), ("n_name", "string"), ("n_regionkey", "int64"),
               ("n_comment", "string")],
    "supplier": [("s_suppkey", "int64"), ("s_name", "string"), ("s_address", "string"),
                 ("s_nationkey", "int64"), ("s_phone", "string"), ("s_acctbal", "decimal"),
                 ("s_comment", "string")],
    "part": [("p_partkey", "int64"), ("p_name", "string"), ("p_mfgr", "string"),
             ("p_brand", "string"), ("p_type", "string"), ("p_size", "int64"),
             ("p_container", "string"), ("p_retailprice", "decimal"), ("p_comment", "string")],
    "partsupp": [("ps_partkey", "int64"), ("ps_suppkey", "int64"), ("ps_availqty", "int64"),
                 ("ps_supplycost", "decimal"), ("ps_comment", "string")],
    "customer": [("c_custkey", "int64"), ("c_name", "string"), ("c_address", "string"),
                 ("c_nationkey", "int64"), ("c_phone", "string"), ("c_acctbal", "decimal"),
                 ("c_mktsegment", "string"), ("c_comment", "string")],
    "orders": [("o_orderkey", "int64"), ("o_custkey", "int64"), ("o_orderstatus", "string"),
               ("o_totalprice", "decimal"), ("o_orderdate", "date"), ("o_orderpriority", "string"),
               ("o_clerk", "string"), ("o_shippriority", "int64"), ("o_comment", "string")],
    "lineitem": [("l_orderkey", "int64"), ("l_partkey", "int64"), ("l_suppkey", "int64"),
                 ("l_linenumber", "int64"), ("l_quantity", "decimal"),
                 ("l_extendedprice", "decimal"), ("l_discount", "decimal"), ("l_tax", "decimal"),
                 ("l_returnflag", "string"), ("l_linestatus", "string"), ("l_shipdate", "date"),
                 ("l_commitdate", "date"), ("l_receiptdate", "date"),
                 ("l_shipinstruct", "string"), ("l_shipmode", "string"), ("l_comment", "string")],
}
KINDS = {c: k for cols in SCHEMA.values() for c, k in cols}


def days(iso: str) -> int:
    """Days from 1970-01-01 to the date ``iso``."""
    return int((np.datetime64(iso, "D") - np.datetime64("1970-01-01", "D")).astype(np.int64))


@dataclass
class TpchData:
    """The generated tables as host numpy arrays in their storage form:
    ``tables[table][column]``, and for each string column its sorted,
    distinct ``vocab[column]`` (object array) that the codes index."""

    sf: float
    seed: int
    tables: dict
    vocab: dict

    def nrows(self, table: str) -> int:
        return len(next(iter(self.tables[table].values())))


def _sorted_vocab(strings) -> tuple[np.ndarray, np.ndarray]:
    """(sorted distinct strings, rank): ``rank[i]`` is the position of
    ``strings[i]`` among them."""
    uniq, inv = np.unique(np.asarray(strings, dtype=object), return_inverse=True)
    return uniq, inv.astype(np.int32)


def _pool(rng: np.random.Generator, words, k: int, nwords: int) -> np.ndarray:
    """Up to ``k`` distinct strings of ``nwords`` words each, sorted."""
    w = np.asarray(words, dtype=object)
    idx = rng.integers(0, len(w), (k, nwords))
    return np.unique(np.array([" ".join(row) for row in w[idx]], dtype=object))


class _Draws:
    """Bulk draws on ``device`` from one seeded generator."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed)

    def ints(self, lo: int, hi: int, n: int) -> torch.Tensor:
        """``n`` int64 values uniform in [lo, hi)."""
        return torch.randint(lo, hi, (n,), generator=self.g, device=self.device, dtype=torch.int64)

    def codes(self, k: int, n: int) -> torch.Tensor:
        """``n`` int32 codes uniform in [0, k)."""
        return self.ints(0, k, n).to(torch.int32)


def generate(sf: float, seed: int, device) -> TpchData:
    """The eight TPC-H tables at scale factor ``sf`` from ``seed``, drawn
    on ``device`` and returned in host memory."""
    dev = torch.device(device)
    seed_u = int(seed) % (1 << 64)
    rng = np.random.default_rng(seed_u)
    d = _Draws(seed_u, dev)

    n_part = max(int(200_000 * sf), 20)
    n_supp = max(int(10_000 * sf), 5)
    n_cust = max(int(150_000 * sf), 15)
    n_ord = max(int(1_500_000 * sf), 150)
    n_nation = len(NATIONS)

    vocab: dict[str, np.ndarray] = {}
    pool6 = _pool(rng, COMMENT_WORDS, POOL, 6)
    pool3 = _pool(rng, COMMENT_WORDS, POOL, 3)

    def fixed(col: str, values, idx: torch.Tensor) -> torch.Tensor:
        """Codes of ``values[idx]`` in ``col``'s sorted vocabulary."""
        vocab[col], rank = _sorted_vocab(values)
        return torch.from_numpy(rank).to(dev)[idx]

    def pooled(col: str, pool: np.ndarray, n: int) -> torch.Tensor:
        vocab[col] = pool
        return d.codes(len(pool), n)

    def numbered(col: str, prefix: str, n: int) -> torch.Tensor:
        """``prefix#000000001``..: distinct, already in sorted order."""
        vocab[col] = np.array([f"{prefix}#{i:09d}" for i in range(1, n + 1)], dtype=object)
        return torch.arange(n, dtype=torch.int32, device=dev)

    locals_ = np.unique(np.array(
        [f"{a}-{b}-{c}" for a, b, c in zip(rng.integers(100, 1000, PHONE_POOL),
                                          rng.integers(100, 1000, PHONE_POOL),
                                          rng.integers(1000, 10000, PHONE_POOL))], dtype=object))
    phones = np.array([f"{n + 10}-{loc}" for n in range(n_nation) for loc in locals_], dtype=object)

    def phone(col: str, nation: torch.Tensor) -> torch.Tensor:
        vocab[col] = phones  # sorted: two-digit country codes, then sorted local parts
        return (nation * len(locals_) + d.ints(0, len(locals_), len(nation))).to(torch.int32)

    out: dict[str, dict[str, torch.Tensor]] = {}
    ar = lambda n, lo=1: torch.arange(lo, lo + n, dtype=torch.int64, device=dev)  # noqa: E731

    out["region"] = {
        "r_regionkey": ar(len(REGIONS), 0),
        "r_name": fixed("r_name", REGIONS, ar(len(REGIONS), 0)),
        "r_comment": pooled("r_comment", pool6, len(REGIONS)),
    }
    out["nation"] = {
        "n_nationkey": ar(n_nation, 0),
        "n_name": fixed("n_name", [n for n, _ in NATIONS], ar(n_nation, 0)),
        "n_regionkey": torch.tensor([r for _, r in NATIONS], dtype=torch.int64, device=dev),
        "n_comment": pooled("n_comment", pool6, n_nation),
    }

    s_nation = d.ints(0, n_nation, n_supp)
    complaints = np.array([c + " Customer Complaints" for c in pool6], dtype=object)
    s_vocab, s_rank = _sorted_vocab(np.concatenate([pool6, complaints]))
    vocab["s_comment"] = s_vocab
    s_comment = d.ints(0, len(pool6), n_supp) + len(pool6) * (d.ints(0, 100, n_supp) == 0)
    out["supplier"] = {
        "s_suppkey": ar(n_supp),
        "s_name": numbered("s_name", "Supplier", n_supp),
        "s_address": pooled("s_address", pool3, n_supp),
        "s_nationkey": s_nation,
        "s_phone": phone("s_phone", s_nation),
        "s_acctbal": d.ints(-99_999, 1_000_000, n_supp),
        "s_comment": torch.from_numpy(s_rank).to(dev)[s_comment],
    }

    brand_m = d.ints(0, 5, n_part)
    brand_n = d.ints(0, 5, n_part)
    ptype = (d.ints(0, len(TYPE_S1), n_part) * len(TYPE_S2) + d.ints(0, len(TYPE_S2), n_part)) \
        * len(TYPE_S3) + d.ints(0, len(TYPE_S3), n_part)
    cont = d.ints(0, len(CONTAINER_S1), n_part) * len(CONTAINER_S2) + d.ints(0, len(CONTAINER_S2), n_part)
    pk = ar(n_part)
    out["part"] = {
        "p_partkey": pk,
        "p_name": pooled("p_name", _pool(rng, COLORS, POOL, 5), n_part),
        "p_mfgr": fixed("p_mfgr", [f"Manufacturer#{m}" for m in range(1, 6)], brand_m),
        "p_brand": fixed("p_brand", [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)],
                         brand_m * 5 + brand_n),
        "p_type": fixed("p_type", [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3],
                        ptype),
        "p_size": d.ints(1, 51, n_part),
        "p_container": fixed("p_container", [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2],
                             cont),
        # 900 + (k % 1000) / 10 + 100 * (k % 10), in cents
        "p_retailprice": 90_000 + (pk % 1000) * 10 + (pk % 10) * 10_000,
        "p_comment": pooled("p_comment", pool3, n_part),
    }

    ps_part = pk.repeat_interleave(4)
    n_ps = len(ps_part)
    ps_j = torch.arange(4, dtype=torch.int64, device=dev).repeat(n_part)
    out["partsupp"] = {
        "ps_partkey": ps_part,
        "ps_suppkey": (ps_part - 1 + ps_j * (n_supp // 4 + 1)) % n_supp + 1,
        "ps_availqty": d.ints(1, 10_000, n_ps),
        "ps_supplycost": d.ints(100, 100_001, n_ps),
        "ps_comment": pooled("ps_comment", pool6, n_ps),
    }

    c_nation = d.ints(0, n_nation, n_cust)
    out["customer"] = {
        "c_custkey": ar(n_cust),
        "c_name": numbered("c_name", "Customer", n_cust),
        "c_address": pooled("c_address", pool3, n_cust),
        "c_nationkey": c_nation,
        "c_phone": phone("c_phone", c_nation),
        "c_acctbal": d.ints(-99_999, 1_000_000, n_cust),
        "c_mktsegment": fixed("c_mktsegment", SEGMENTS, d.ints(0, 5, n_cust)),
        "c_comment": pooled("c_comment", pool6, n_cust),
    }

    o_date = d.ints(days("1992-01-01"), days("1998-08-02") + 1, n_ord).to(torch.int32)
    n_clerk = max(n_supp, 2) - 1
    out["orders"] = {
        "o_orderkey": ar(n_ord) * 4 - 3,
        # a third of the customers place no order (TPC-H 4.2.3)
        "o_custkey": d.ints(0, max(n_cust * 2 // 3, 1), n_ord) * 3 % n_cust + 1,
        "o_orderstatus": fixed("o_orderstatus", ["F", "O", "P"], d.ints(0, 3, n_ord)),
        "o_totalprice": d.ints(100_000, 50_000_001, n_ord),
        "o_orderdate": o_date,
        "o_orderpriority": fixed("o_orderpriority", PRIORITIES, d.ints(0, 5, n_ord)),
        "o_clerk": numbered("o_clerk", "Clerk", n_clerk)[d.ints(0, n_clerk, n_ord)],
        "o_shippriority": torch.zeros(n_ord, dtype=torch.int64, device=dev),
        "o_comment": pooled("o_comment", pool6, n_ord),
    }

    per_order = d.ints(1, 8, n_ord)
    n_li = n_ord * DBGEN_SF10_LINEITEM // DBGEN_SF10_ORDERS
    diff = n_li - int(per_order.sum())
    if diff:
        movable = torch.nonzero(per_order < 7 if diff > 0 else per_order > 1).squeeze(1)
        if abs(diff) > len(movable):
            raise ValueError(f"cannot draw {n_li} lineitem rows for {n_ord} orders")
        pick = movable[torch.randperm(len(movable), generator=d.g, device=dev)[:abs(diff)]]
        per_order[pick] += 1 if diff > 0 else -1
    order_idx = torch.arange(n_ord, device=dev).repeat_interleave(per_order)
    first = torch.cumsum(per_order, 0) - per_order
    l_part = d.ints(1, n_part + 1, n_li)
    qty = d.ints(1, 51, n_li)
    odate = o_date[order_idx]
    ship = odate + d.ints(1, 122, n_li).to(torch.int32)
    commit = odate + d.ints(30, 91, n_li).to(torch.int32)
    receipt = ship + d.ints(1, 31, n_li).to(torch.int32)
    cutoff = days("1995-06-17")
    flags = torch.where(receipt > cutoff, 2, d.ints(0, 2, n_li))  # R, A or N as drawn
    out["lineitem"] = {
        "l_orderkey": out["orders"]["o_orderkey"][order_idx],
        "l_partkey": l_part,
        "l_suppkey": (l_part - 1 + d.ints(0, 4, n_li) * (n_supp // 4 + 1)) % n_supp + 1,
        "l_linenumber": torch.arange(n_li, dtype=torch.int64, device=dev) - first[order_idx] + 1,
        "l_quantity": qty * 100,
        "l_extendedprice": qty * out["part"]["p_retailprice"][l_part - 1],
        "l_discount": d.ints(0, 11, n_li),
        "l_tax": d.ints(0, 9, n_li),
        "l_returnflag": fixed("l_returnflag", ["R", "A", "N"], flags),
        "l_linestatus": fixed("l_linestatus", ["O", "F"], (ship <= cutoff).to(torch.int64)),
        "l_shipdate": ship,
        "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": fixed("l_shipinstruct", INSTRUCTIONS, d.ints(0, 4, n_li)),
        "l_shipmode": fixed("l_shipmode", SHIPMODES, d.ints(0, 7, n_li)),
        "l_comment": pooled("l_comment", pool3, n_li),
    }

    storage = {"int64": torch.int64, "decimal": torch.int64, "date": torch.int32, "string": torch.int32}
    tables = {}
    for t, cols in SCHEMA.items():
        tables[t] = {}
        for c, kind in cols:
            x = out[t].pop(c)
            if x.dtype != storage[kind]:
                raise AssertionError(f"{c}: drawn as {x.dtype}, stored as {storage[kind]}")
            tables[t][c] = x.cpu().numpy()
            del x
        out[t].clear()
    return TpchData(sf=sf, seed=int(seed), tables=tables, vocab=vocab)
