"""ctypes wrapper over the native C++ batch image loader (port of
``cl_multiview_stereo_tpu/io/native_loader.py``).

``load_image_array_native`` is a drop-in replacement for
``images.load_image_array`` that decodes the whole camera array with a C++
thread pool (PNG via libpng, JPEG via libjpeg), from the port's own copy of
``native/loader.cc``.  A cached library that does not open on this host is
built again (``native/build.load``).  Where ``g++`` or the libpng/libjpeg
headers are absent, for a first build or for that rebuild, it decodes with
PIL, as the JAX module does, and warns; any other failure to build or load
the library raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import warnings

import numpy as np

from cl_multiview_stereo_tpu_torch.io.images import load_image_array, read_image_list
from cl_multiview_stereo_tpu_torch.native import build


@functools.cache
def _library() -> tuple[ctypes.CDLL | None, str]:
    """(the library, "") or (None, why the toolchain is missing)."""
    try:
        return build.load(), ""
    except build.ToolchainMissing as e:
        warnings.warn(f"native image loader unavailable, decoding with PIL: {e}", stacklevel=3)
        return None, str(e)


def _load() -> ctypes.CDLL | None:
    return _library()[0]


def native_available() -> bool:
    return _load() is not None


def load_image_array_native(
    list_path: str, view_num: int | None = None, threads: int | None = None
) -> np.ndarray:
    """Load (V, H, W, 3) uint8 RGB via the C++ loader; PIL where the
    toolchain is missing.  A failed probe or decode raises ``IOError``
    naming the image."""
    lib = _load()
    if lib is None:
        return load_image_array(list_path, view_num)
    paths = read_image_list(list_path, view_num)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mvs_probe(paths[0].encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"probe failed ({rc}) for {paths[0]}")
    n = len(paths)
    out = np.empty((n, h.value, w.value, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    nthreads = threads if threads is not None else min(n, os.cpu_count() or 1)
    rc = lib.mvs_load_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h.value, w.value, nthreads
    )
    if rc != 0:
        idx = rc - 100
        raise IOError(f"native decode failed for {paths[idx] if 0 <= idx < n else rc}")
    return out
