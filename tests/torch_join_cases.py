"""Join edge tables shared by tests/test_torch_joins.py (the port against
the JAX package on the CPU) and tests/test_torch_gpu.py (the card against
the CPU): {name: (probe side, build side)}, keys ``k`` and ``k2``."""

import numpy as np

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")

EDGE_SIDES = {
    "null-keys": ({"k": [1, None, 2, None, 3], "lv": [10, 11, 12, 13, 14]},
                  {"k2": [None, 2, 2, 4, None], "rv": ["a", "b", "c", "d", "e"]}),
    "empty-build": ({"k": [1, 2, 3], "lv": [10, 11, 12]},
                    {"k2": np.zeros(0, np.int64), "rv": np.array([], dtype=object)}),
    "empty-probe": ({"k": np.zeros(0, np.int64), "lv": np.zeros(0, np.int64)},
                    {"k2": [1, 2], "rv": ["a", "b"]}),
    "fan-out": ({"k": [1, 1, 2, 3, 4, 2], "lv": [10, 11, 12, 13, 14, 15]},
                {"k2": [2, 1, 1, 5, 1, 2], "rv": ["a", "b", "c", "d", "e", "f"]}),
}
