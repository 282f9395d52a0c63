"""TPC-H data for the port: the eight tables at any scale factor, made from
a seed with numpy, and a loader that registers them on a device.

A copy of the JAX package's benchmark generator (``bench/tpch_datagen.py``,
a dbgen approximation with TPC-H's schemas and value domains), so the
port imports nothing of that package: the same ``(sf, seed)`` gives the
same arrays.  Keys are dense: ``o_orderkey = 4i - 3`` for order i, every
other key runs 1..n.  SF1 generates in seconds, so nothing is cached.
"""

from __future__ import annotations

import numpy as np

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
INSTRUCTIONS = [
    "DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN",
]
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

_EPOCH = np.datetime64("1970-01-01", "D")


def _date(lo: str, hi: str, rng, n) -> np.ndarray:
    a = (np.datetime64(lo, "D") - _EPOCH).astype(int)
    b = (np.datetime64(hi, "D") - _EPOCH).astype(int)
    return rng.integers(a, b + 1, n).astype(np.int32)


_POOL = 1 << 16


def _comments(rng, n, nwords=6) -> np.ndarray:
    """Random keyword-join comments.  Above _POOL rows, sample from a pool of
    _POOL distinct strings instead of synthesizing n of them: the Python
    join loop stays bounded, keyword selectivities (q13 '%special%requests%',
    q16 '%Customer%Complaints%') are preserved by the pool's randomness, and
    the object array holds references to 64k shared strings (pickle memo
    keeps the SF10 cache small)."""
    words = np.array(COMMENT_WORDS)
    k = min(n, _POOL)
    idx = rng.integers(0, len(words), (k, nwords))
    pool = np.array([" ".join(row) for row in words[idx]], dtype=object)
    if k == n:
        return pool
    return pool[rng.integers(0, k, n)]


def _phone(rng, nation, n):
    a = nation + 10
    b = rng.integers(100, 999, n)
    c = rng.integers(100, 999, n)
    d = rng.integers(1000, 9999, n)
    if n <= _POOL:
        return np.array(
            [f"{x}-{y}-{z}-{w}" for x, y, z, w in zip(a, b, c, d)], dtype=object
        )
    s = np.char.add(np.char.add(a.astype("U2"), "-"), b.astype("U3"))
    s = np.char.add(np.char.add(s, "-"), c.astype("U3"))
    s = np.char.add(np.char.add(s, "-"), d.astype("U4"))
    return s.astype(object)


def generate_tpch(sf: float = 0.01, seed: int = 42) -> dict[str, dict]:
    """{table name: {column: host numpy array}} for the eight TPC-H tables at
    scale factor ``sf``, from ``seed``."""
    rng = np.random.default_rng(seed)

    n_part = max(int(200_000 * sf), 20)
    n_supp = max(int(10_000 * sf), 5)
    n_cust = max(int(150_000 * sf), 15)
    n_ord = max(int(1_500_000 * sf), 150)
    n_nation = 25

    out: dict[str, dict] = {}

    # ---- region -------------------------------------------------------------
    out["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS, dtype=object),
        "r_comment": _comments(rng, 5),
    }

    # ---- nation --------------------------------------------------------------
    out["nation"] = {
        "n_nationkey": np.arange(n_nation, dtype=np.int64),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": _comments(rng, n_nation),
    }

    # ---- supplier ---------------------------------------------------------------
    s_nation = rng.integers(0, n_nation, n_supp)
    out["supplier"] = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)], dtype=object),
        "s_address": _comments(rng, n_supp, 3),
        "s_nationkey": s_nation.astype(np.int64),
        "s_phone": _phone(rng, s_nation, n_supp),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": np.array([
            c + (" Customer Complaints" if rng.random() < 0.01 else "")
            for c in _comments(rng, n_supp)
        ], dtype=object),
    }

    # ---- part -----------------------------------------------------------------
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    t1 = rng.integers(0, len(TYPE_S1), n_part)
    t2 = rng.integers(0, len(TYPE_S2), n_part)
    t3 = rng.integers(0, len(TYPE_S3), n_part)
    c1 = rng.integers(0, len(CONTAINER_S1), n_part)
    c2 = rng.integers(0, len(CONTAINER_S2), n_part)
    names = np.array(
        ["moccasin", "thistle", "powder", "lavender", "sienna", "indian",
         "linen", "honeydew", "navajo", "lace", "cornflower", "almond",
         "antique", "aquamarine", "azure", "beige", "bisque", "black",
         "blanched", "blue", "blush", "brown", "burlywood", "burnished",
         "green", "forest", "chartreuse", "ivory", "khaki", "lemon",
         "magenta", "maroon", "olive", "orange", "pink", "plum", "red",
         "rose", "salmon", "sandy", "seashell", "sky", "slate", "smoke",
         "snow", "spring", "steel", "tan", "tomato", "turquoise", "violet",
         "wheat", "white", "yellow"]
    )
    kp = min(n_part, _POOL)
    pn = names[rng.integers(0, len(names), (kp, 5))]
    p_name_pool = np.array([" ".join(r) for r in pn], dtype=object)
    p_name = (
        p_name_pool if kp == n_part else p_name_pool[rng.integers(0, kp, n_part)]
    )
    # vocab-indexed string columns: same values as per-row f-strings, but one
    # Python loop over the (tiny) vocabulary instead of over n_part rows
    mfgr_vocab = np.array([f"Manufacturer#{m}" for m in range(1, 6)], dtype=object)
    brand_vocab = np.array(
        [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)], dtype=object
    )
    type_vocab = np.array(
        [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3],
        dtype=object,
    )
    cont_vocab = np.array(
        [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2], dtype=object
    )
    out["part"] = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": p_name,
        "p_mfgr": mfgr_vocab[brand_m - 1],
        "p_brand": brand_vocab[(brand_m - 1) * 5 + (brand_n - 1)],
        "p_type": type_vocab[
            (t1 * len(TYPE_S2) + t2) * len(TYPE_S3) + t3
        ],
        "p_size": rng.integers(1, 51, n_part).astype(np.int64),
        "p_container": cont_vocab[c1 * len(CONTAINER_S2) + c2],
        "p_retailprice": np.round(
            900 + (np.arange(1, n_part + 1) % 1000) / 10
            + 100 * (np.arange(1, n_part + 1) % 10), 2
        ),
        "p_comment": _comments(rng, n_part, 3),
    }

    # ---- partsupp -----------------------------------------------------------------
    ps_part = np.repeat(np.arange(1, n_part + 1), 4)
    n_ps = len(ps_part)
    ps_supp = ((ps_part - 1 + (np.tile(np.arange(4), n_part)) * (n_supp // 4 + 1)) % n_supp) + 1
    out["partsupp"] = {
        "ps_partkey": ps_part.astype(np.int64),
        "ps_suppkey": ps_supp.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps).astype(np.int64),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
        "ps_comment": _comments(rng, n_ps),
    }

    # ---- customer ---------------------------------------------------------------
    c_nation = rng.integers(0, n_nation, n_cust)
    out["customer"] = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)], dtype=object),
        "c_address": _comments(rng, n_cust, 3),
        "c_nationkey": c_nation.astype(np.int64),
        "c_phone": _phone(rng, c_nation, n_cust),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": np.array(SEGMENTS, dtype=object)[rng.integers(0, 5, n_cust)],
        "c_comment": _comments(rng, n_cust),
    }

    # ---- orders ------------------------------------------------------------------
    o_cust = (rng.integers(0, max(n_cust * 2 // 3, 1), n_ord) * 3 % n_cust) + 1
    o_date = _date("1992-01-01", "1998-08-02", rng, n_ord)
    out["orders"] = {
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3,
        "o_custkey": o_cust.astype(np.int64),
        "o_orderstatus": np.array(["F", "O", "P"], dtype=object)[
            rng.integers(0, 3, n_ord)
        ],
        "o_totalprice": np.round(rng.uniform(1000.0, 500_000.0, n_ord), 2),
        "o_orderdate": o_date,
        "o_orderpriority": np.array(PRIORITIES, dtype=object)[
            rng.integers(0, 5, n_ord)
        ],
        "o_clerk": np.array(
            [f"Clerk#{i:09d}" for i in range(1, max(n_supp, 2))], dtype=object
        )[rng.integers(1, max(n_supp, 2), n_ord) - 1],
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _comments(rng, n_ord),
    }

    # ---- lineitem ----------------------------------------------------------------
    per_order = rng.integers(1, 8, n_ord)
    l_order_idx = np.repeat(np.arange(n_ord), per_order)
    n_li = len(l_order_idx)
    l_part = rng.integers(1, n_part + 1, n_li)
    # supplier from the part's partsupp set
    which = rng.integers(0, 4, n_li)
    l_supp = ((l_part - 1 + which * (n_supp // 4 + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n_li)
    retail = out["part"]["p_retailprice"][l_part - 1]
    extended = np.round(qty * retail, 2)
    odate = o_date[l_order_idx]
    ship_delta = rng.integers(1, 122, n_li)
    commit_delta = rng.integers(30, 91, n_li)
    receipt_delta = rng.integers(1, 31, n_li)
    out["lineitem"] = {
        "l_orderkey": out["orders"]["o_orderkey"][l_order_idx],
        "l_partkey": l_part.astype(np.int64),
        "l_suppkey": l_supp.astype(np.int64),
        "l_linenumber": (
            np.arange(n_li)
            - np.repeat(np.cumsum(per_order) - per_order, per_order)
            + 1
            if n_ord
            else np.zeros(0)
        ).astype(np.int64),
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": extended,
        "l_discount": np.round(rng.integers(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n_li) / 100.0, 2),
        "l_returnflag": np.array(["R", "A", "N"], dtype=object)[
            np.where(
                odate + ship_delta + receipt_delta
                > (np.datetime64("1995-06-17") - _EPOCH).astype(int),
                2,
                rng.integers(0, 2, n_li),
            )
        ],
        "l_linestatus": np.where(
            odate + ship_delta > (np.datetime64("1995-06-17") - _EPOCH).astype(int),
            "O",
            "F",
        ).astype(object),
        "l_shipdate": (odate + ship_delta).astype(np.int32),
        "l_commitdate": (odate + commit_delta).astype(np.int32),
        "l_receiptdate": (odate + ship_delta + receipt_delta).astype(np.int32),
        "l_shipinstruct": np.array(INSTRUCTIONS, dtype=object)[
            rng.integers(0, 4, n_li)
        ],
        "l_shipmode": np.array(SHIPMODES, dtype=object)[rng.integers(0, 7, n_li)],
        "l_comment": _comments(rng, n_li, 3),
    }

    return out


# Columns holding dates as int32 days since the epoch
DATE_COLUMNS = {
    "o_orderdate",
    "l_shipdate",
    "l_commitdate",
    "l_receiptdate",
}

# Decimal(15,2) columns per the TPC-H schema
DECIMAL_COLUMNS = {
    "s_acctbal",
    "p_retailprice",
    "ps_supplycost",
    "c_acctbal",
    "o_totalprice",
    "l_quantity",
    "l_extendedprice",
    "l_discount",
    "l_tax",
}


def tpch_table(cols: dict, device=None):
    """One table of ``generate_tpch``'s output as a Table on ``device``
    (None: the CUDA card), dates as date32 and money as decimal(15,2)."""
    from .columnar.table import Table
    from .types.dtypes import DATE32, decimal

    dtypes = {}
    for n in cols:
        if n in DATE_COLUMNS:
            dtypes[n] = DATE32
        elif n in DECIMAL_COLUMNS:
            dtypes[n] = decimal(15, 2)
    return Table.from_pydict(cols, dtypes=dtypes, device=device)


def register_tpch(ctx, data: dict, device=None) -> None:
    """Register every table of ``data`` (``generate_tpch``'s output) with an
    ExecutionContext, on ``device`` (default: the context's device)."""
    dev = ctx.device if device is None else device
    for tname, cols in data.items():
        ctx.register_table(tname, tpch_table(cols, dev))
