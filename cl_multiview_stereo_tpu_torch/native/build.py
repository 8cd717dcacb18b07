"""Build and load the native image loader (``loader.cc``: a thread-pool
PNG/JPEG decoder and a background scene prefetcher behind a plain C ABI).

The build runs at first use, from this checkout's source only, with
``g++`` against libpng, libjpeg and zlib, into ``_build/`` beside the
package's ``csrc/`` (listed in ``.gitignore``), as ``kernels/build.py``
builds the CUDA kernels: the file name carries a hash of the source and the
flags, and the library is written under a temporary name and renamed into
place, so that concurrent builds (test workers) never load half a file.

A cached library that does not open (one built on a host with libpng and
libjpeg, copied to a host without them) is not a build: :func:`load` builds
it again in place, through the same host checks, as the JAX package rebuilds
a stale library.

One absence is not an error: without ``g++`` or the libpng/libjpeg headers
:func:`load` raises :class:`ToolchainMissing` (naming, after a cached library
failed to open, the loader's message too), and the loaders decode with PIL
instead, saying so.  Any other failure raises: a compile error with the
compiler's log, and a freshly built library that does not open with
``OSError``, its path and the loader's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = _PKG / "_build"

CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")
# what loader.cc includes from outside the C++ standard library
_HEADERS = "#include <cstdio>\n#include <png.h>\n#include <jpeglib.h>\n"


class ToolchainMissing(RuntimeError):
    """``g++`` or the libpng/libjpeg headers are not installed."""


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise ToolchainMissing("g++ not found")
    return found


def _check_headers(gxx: str) -> None:
    proc = subprocess.run(
        [gxx, "-fsyntax-only", "-x", "c++", "-"], input=_HEADERS, capture_output=True, text=True
    )
    if proc.returncode != 0:
        first = next((ln for ln in proc.stderr.splitlines() if "error" in ln), proc.stderr.strip())
        raise ToolchainMissing(f"libpng/libjpeg headers not found ({first.strip()})")


def library_path() -> Path:
    """Where the build of this source and these flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libmvsloader-{digest[:16]}.so"


def build(cached: bool = True) -> tuple[Path, str]:
    """Compile ``loader.cc`` unless ``cached`` and a build of the same
    source and flags exists.  Returns (library path, compiler log; empty
    when cached)."""
    out = library_path()
    if cached and out.exists():
        return out, ""
    gxx = _gxx()
    _check_headers(gxx)
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for loader.cc (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, proc.stderr


def _open_fresh(path: Path) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise OSError(f"the freshly built {path} does not open: {e}") from e


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the library (once per process), with every
    entry point's argument and result types declared.  A cached library
    that does not open is built again."""
    from_cache = library_path().exists()
    path, _ = build()
    if not from_cache:
        lib = _open_fresh(path)
    else:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as stale:
            first = (str(stale).splitlines() or [repr(stale)])[0]
            try:
                path, _ = build(cached=False)
            except ToolchainMissing as e:
                raise ToolchainMissing(f"{e}; the cached {path.name} does not open ({first})") from stale
            lib = _open_fresh(path)
    u8p, intp = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
    strs = ctypes.POINTER(ctypes.c_char_p)
    signatures = {
        "mvs_probe": ([ctypes.c_char_p, intp, intp], ctypes.c_int),
        "mvs_load_batch": ([strs, ctypes.c_int, u8p] + [ctypes.c_int] * 3, ctypes.c_int),
        "mvs_prefetcher_create": ([strs, intp] + [ctypes.c_int] * 5, ctypes.c_void_p),
        "mvs_prefetcher_next": ([ctypes.c_void_p, u8p], ctypes.c_int),
        "mvs_prefetcher_destroy": ([ctypes.c_void_p], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
