"""RGB -> CIELab conversion (port of ``cl_multiview_stereo_tpu/ops/color.py``).

Same constants and channel convention as the JAX module: RGB uint8 input,
scaled by the reference's ``0.0039216``, no sRGB linearization on the live
path.

:func:`rgb_to_lab` routes by the device of its input (:func:`route`): on a
CUDA tensor it launches ``lab_convert`` (``csrc/color.cu``: tiles of
pixels staged through shared memory) or raises, on a CPU tensor it runs the plain form
:func:`rgb_to_lab_reference`; any other device raises.  Nothing falls back
from one to the other.  The kernel repeats the op sequence that the plain
form runs on the card, so it is bitwise that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cl_multiview_stereo_tpu_torch.kernels import build

_SCALE = 0.0039216
_EPSILON = 0.008856
_KAPPA = 903.3
_WHITE = (0.950456, 1.0, 1.088754)
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)

# The kernel's launches since import (or since the caller reset them):
# chip_smoke.py reads them to show that the main path went through it.
LAUNCHES = {"lab_convert": 0}
# pointer and int arguments of the C entry, in order, before the stream
# (kernels/build.py's library "color")
_ENTRIES = {"lab_convert": (2, 2, 0)}
# the most pixels one launch takes (csrc/color.cu's kMaxPixels)
_MAX_PIXELS = 2**30


def route(device) -> str:
    """Where an image on ``device`` is converted: ``"plain"`` (the plain
    form) on the CPU, ``"kernel"`` on a CUDA device; any other device
    raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "kernel"
    raise ValueError(f"no Lab kernel for device {device}")


@functools.cache
def _entry(name: str):
    """The C entry ``<name>_launch`` of ``csrc/color.cu``, built at first use."""
    fn = getattr(build.load("color"), f"{name}_launch")
    ptrs, ints, floats = _ENTRIES[name]
    fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_float] * floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, dev: torch.device, *args) -> None:
    """Calls kernel ``name``'s entry with ``args`` and the current stream of
    ``dev``; raises on a CUDA error and counts the launch."""
    fn = _entry(name)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    """CIE f(): cube root above epsilon, linear below.  torch has no cbrt;
    ``pow(t, 1/3)`` on non-negative input is within a few ulps of it."""
    return torch.where(
        t > _EPSILON,
        torch.pow(torch.clamp(t, min=0.0), 1.0 / 3.0),
        (_KAPPA * t + 16.0) / 116.0,
    )


def rgb_to_lab_reference(rgb: torch.Tensor) -> torch.Tensor:
    """Plain form of :func:`rgb_to_lab`, on any device."""
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


def _lab_kernel(rgb: torch.Tensor) -> torch.Tensor:
    """One ``lab_convert`` launch: uint8 and float32 images as they are,
    any other dtype cast to float32 first, as the plain form casts it."""
    dtype = torch.uint8 if rgb.dtype == torch.uint8 else torch.float32
    rgb = rgb.to(dtype).contiguous()
    build.check_input("rgb", rgb, dtype, (*rgb.shape[:-1], 3), rgb.device)
    if rgb.numel() // 3 > _MAX_PIXELS:
        raise ValueError(f"{rgb.numel() // 3} pixels, the kernel takes at most {_MAX_PIXELS}")
    out = torch.empty(rgb.shape, dtype=torch.float32, device=rgb.device)
    if out.numel():
        _launch("lab_convert", rgb.device, rgb.data_ptr(), out.data_ptr(), out.numel() // 3,
                int(rgb.dtype == torch.float32))
    return out


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` RGB (uint8 or float in [0, 255]) -> float32 Lab, D65,
    contiguous.

    A CUDA ``rgb`` launches ``lab_convert`` once; a CPU one runs
    :func:`rgb_to_lab_reference`; another device raises."""
    if route(rgb.device) == "plain":
        return rgb_to_lab_reference(rgb)
    return _lab_kernel(rgb)
