"""ctypes bindings for the native host runtime (``csrc/dftpu_native.cpp``).

Port of ``datafusion_tpu/native_lib.py``.  The device path is PyTorch and
CUDA; the host hot paths are C++: the columnar CSV/TBL loader and the
shuffle partitioner's counting sort.  The library is built at first use
with ``g++``, called directly, into ``_build/`` beside this file; its name
carries a hash of the source and flags, so an edited source is rebuilt.
When no compiler is present or the build fails, ``get_lib()`` returns None
(``BUILD_ERROR`` says why) and callers fall back to pure Python or
pyarrow; ``CsvFile.loader`` records which loader read a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "dftpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Wno-unused-parameter", "-shared"]

# why the library is unavailable, when it is
BUILD_ERROR: str | None = None

_lib = None
_lib_lock = threading.Lock()
_tried = False

# column kind codes (must match ColKind in dftpu_native.cpp)
K_INT64, K_FLOAT64, K_DATE32, K_DECIMAL, K_BOOL, K_STRING, K_TIMESTAMP = range(7)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdftpu_native-{digest}.so"


def _build() -> Path:
    """Compile the library unless it is built; raises with the compiler's
    output when that fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def get_lib():
    """The loaded shared library (built on first use), or None."""
    global _lib, _tried, BUILD_ERROR
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            BUILD_ERROR = str(e)
            return None
        lib.dftpu_csv_open.restype = ctypes.c_void_p
        lib.dftpu_csv_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dftpu_csv_nrows.restype = ctypes.c_long
        lib.dftpu_csv_nrows.argtypes = [ctypes.c_void_p]
        lib.dftpu_csv_column.restype = None
        lib.dftpu_csv_column.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.dftpu_csv_dict_size.restype = ctypes.c_long
        lib.dftpu_csv_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dftpu_csv_dict_bytes.restype = ctypes.c_long
        lib.dftpu_csv_dict_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dftpu_csv_dict_has_newline.restype = ctypes.c_int
        lib.dftpu_csv_dict_has_newline.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dftpu_csv_dict_values.restype = None
        lib.dftpu_csv_dict_values.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.dftpu_csv_free.restype = None
        lib.dftpu_csv_free.argtypes = [ctypes.c_void_p]
        lib.dftpu_partition.restype = None
        lib.dftpu_partition.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def _kind_of(dtype) -> int | None:
    k = dtype.kind
    if k in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        return K_INT64
    if k in ("float32", "float64"):
        return K_FLOAT64
    return {"date32": K_DATE32, "decimal": K_DECIMAL, "bool": K_BOOL,
            "string": K_STRING, "timestamp": K_TIMESTAMP}.get(k)


def load_csv(path: str, schema, delimiter: str = ",", has_header: bool = True, device=None):
    """Parse a CSV/TBL file with the native loader into a Table on
    ``device`` (None: the CUDA card); None when the library is unavailable
    or the schema has a type the loader does not handle (the caller reads
    with pyarrow)."""
    from .columnar.column import Column
    from .columnar.dictionary import StringDict
    from .columnar.table import Table, round_capacity
    from .device import resolve_device

    dev = resolve_device(device)
    lib = get_lib()
    if lib is None:
        return None
    kinds = [_kind_of(f.dtype) for f in schema.fields]
    if any(k is None for k in kinds):
        return None
    scales = [f.dtype.scale if f.dtype.is_decimal else 0 for f in schema.fields]
    n = len(kinds)
    h = lib.dftpu_csv_open(
        path.encode(), delimiter.encode()[:1], 1 if has_header else 0, n,
        (ctypes.c_int * n)(*kinds), (ctypes.c_int * n)(*scales),
    )
    if not h:
        return None
    try:
        nrows = lib.dftpu_csv_nrows(h)
        if nrows < 0:
            return None
        cap = round_capacity(nrows)
        cols = []
        for j, f in enumerate(schema.fields):
            kk = kinds[j]
            valid = np.zeros(nrows, dtype=np.uint8)
            if kk in (K_INT64, K_DECIMAL, K_TIMESTAMP):
                data = np.zeros(nrows, dtype=np.int64)
            elif kk == K_FLOAT64:
                data = np.zeros(nrows, dtype=np.float64)
            elif kk == K_BOOL:
                data = np.zeros(nrows, dtype=np.uint8)
            else:  # date32 / string codes
                data = np.zeros(nrows, dtype=np.int32)
            lib.dftpu_csv_column(h, j, data.ctypes.data_as(ctypes.c_void_p),
                                 valid.ctypes.data_as(ctypes.c_void_p))
            dic = None
            if kk == K_STRING:
                if lib.dftpu_csv_dict_has_newline(h, j):
                    return None  # rare: the caller reads with pyarrow
                nb = lib.dftpu_csv_dict_bytes(h, j)
                nv = lib.dftpu_csv_dict_size(h, j)
                buf = ctypes.create_string_buffer(int(nb) + 1)
                lib.dftpu_csv_dict_values(h, j, buf)
                raw = buf.raw[: int(nb)].decode("utf-8", errors="replace")
                dic = StringDict(np.array(raw.split("\n")[: int(nv)], dtype=object))
            storage = f.dtype.storage_np_dtype()
            cols.append(Column.from_numpy(f.dtype, data.astype(storage, copy=False), valid.astype(bool),
                                          dic, capacity=cap, device=dev))
        return Table([f.name for f in schema.fields], cols, int(nrows), device=dev)
    finally:
        lib.dftpu_csv_free(h)


def partition_order(hashes: np.ndarray, m: int):
    """Counting-sort permutation for shuffle bucketing: (order[n] int64,
    starts[m+1] int64), stable within each bucket (the contract of a stable
    argsort by bucket), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = len(h)
    order = np.empty(n, dtype=np.int64)
    starts = np.empty(m + 1, dtype=np.int64)
    lib.dftpu_partition(
        h.ctypes.data_as(ctypes.c_void_p), n, m,
        order.ctypes.data_as(ctypes.c_void_p), starts.ctypes.data_as(ctypes.c_void_p),
    )
    return order, starts
