"""Device checks and device-resident constant tables.  Nothing in the port
picks a device on its own: entry points take an explicit ``device`` and
measurement paths call :func:`require_cuda`, which fails instead of falling
back to the CPU."""

from __future__ import annotations

import functools
import subprocess

import numpy as np
import torch


def require_cuda() -> torch.device:
    """Return the CUDA device, or raise when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required, but torch.cuda.is_available() is False"
        )
    return torch.device("cuda")


def card_name() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, the
    string every chip number of the port is written beside."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1024)
def _table(dtype_str: str, shape: tuple, data: bytes, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    host = np.frombuffer(data, dtype=np.dtype(dtype_str)).reshape(shape)
    return torch.from_numpy(host.copy()).to(device=device, dtype=dtype)


def device_table(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (a Python sequence or a numpy array) as a ``dtype`` tensor
    on ``device``, the same bits as ``torch.tensor(values, dtype=dtype)``.
    Built once per (values, dtype, device) and shared, so callers only read
    it: the host-to-device copy happens at the first call, never again (a
    captured CUDA graph may not make one, and on the eager path each one
    waits for the stream).  A tensor is passed on as ``torch.as_tensor``
    would."""
    if isinstance(values, torch.Tensor):
        return torch.as_tensor(values, dtype=dtype, device=device)
    host = np.ascontiguousarray(values)
    return _table(host.dtype.str, host.shape, host.tobytes(), dtype, torch.device(device))
