"""Device checks.  Nothing in the port picks a device on its own: entry
points take an explicit ``device`` and measurement paths call
:func:`require_cuda`, which fails instead of falling back to the CPU."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the CUDA device, or raise when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required, but torch.cuda.is_available() is False"
        )
    return torch.device("cuda")
