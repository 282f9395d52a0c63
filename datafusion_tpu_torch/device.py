"""Device selection and storage-dtype mapping for the torch engine.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card: the engine never carries on silently on the CPU.  Tests and host
tools pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import ExecutionError

_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``, and
    asking for CUDA where there is no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph: its
    work is recorded, not run, and its tensors hold nothing until a replay.
    False where CUDA was never initialized (a CPU build cannot ask)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def torch_dtype(storage) -> torch.dtype:
    """The torch dtype of a numpy storage dtype (``DataType.storage_np_dtype``)."""
    return _TORCH_OF_NP[np.dtype(storage)]
