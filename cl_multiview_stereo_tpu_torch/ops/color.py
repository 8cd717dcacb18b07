"""RGB -> CIELab conversion (port of ``cl_multiview_stereo_tpu/ops/color.py``).

Same constants and channel convention as the JAX module: RGB uint8 input,
scaled by the reference's ``0.0039216``, no sRGB linearization on the live
path.
"""

from __future__ import annotations

import torch

_SCALE = 0.0039216
_EPSILON = 0.008856
_KAPPA = 903.3
_WHITE = (0.950456, 1.0, 1.088754)
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    """CIE f(): cube root above epsilon, linear below.  torch has no cbrt;
    ``pow(t, 1/3)`` on non-negative input is within a few ulps of it."""
    return torch.where(
        t > _EPSILON,
        torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0),
        (_KAPPA * t + 16.0) / 116.0,
    )


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` RGB (uint8 or float in [0, 255]) -> float32 Lab, D65."""
    x = rgb.to(torch.float32) * _SCALE
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    m = _RGB2XYZ
    X = r * m[0][0] + g * m[0][1] + b * m[0][2]
    Y = r * m[1][0] + g * m[1][1] + b * m[1][2]
    Z = r * m[2][0] + g * m[2][1] + b * m[2][2]
    fx = _f_cbrt(X / _WHITE[0])
    fy = _f_cbrt(Y / _WHITE[1])
    fz = _f_cbrt(Z / _WHITE[2])
    L = 116.0 * fy - 16.0
    A = 500.0 * (fx - fy)
    B = 200.0 * (fy - fz)
    return torch.stack([L, A, B], dim=-1)
