"""Native multi-scene prefetching executor (port of
``cl_multiview_stereo_tpu/io/prefetcher.py``).

Streams camera-array scenes through the C++ background decoder
(``native/loader.cc`` ``mvs_prefetcher_*``): while the card computes scene
``i``, the host thread pool is already decoding scenes ``i+1..i+d``.  The
reference blocks its main thread on synchronous loads
(``clMVDE/pipeline.cpp:12``, ``file_handler.cpp:30-57``).

Where the native toolchain is missing (``backend == "pil"``) the scenes
are decoded with PIL, as in the JAX module, but ahead as well: a thread
pool (PIL's decoders release the interpreter lock) keeps ``depth`` scenes
in flight, where the JAX module loads each scene when it is asked for.

For a CUDA device each scene is decoded straight into one of two pinned
host buffers and copied to the card without blocking; a CUDA event per
buffer keeps the decoder from overwriting a buffer whose copy is still in
flight.  :func:`run_scenes` feeds the scenes to ``MVSPipeline.jitted()``.
"""

from __future__ import annotations

import collections
import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.io.images import read_image_list
from cl_multiview_stereo_tpu_torch.io.native_loader import _load

# pinned staging buffers on a CUDA device: the decoder fills one while the
# copy from the other may still run
STAGING_BUFFERS = 2


def _pil_decode(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ScenePrefetcher:
    """Iterate (scene_index, (V, H, W, 3) uint8) with background decoding.

    ``scenes``: list of per-scene image-path lists (all images h x w, all
    scenes the same view count).  ``depth``: scenes decoded ahead.
    ``device``: ``None`` yields each scene as a new numpy array, as the JAX
    module; a device yields it as a tensor there (on a CUDA device through
    the pinned staging buffers).  ``backend`` is ``"native"``, or ``"pil"``
    (PIL decodes on a thread pool) where the native toolchain is missing.
    """

    def __init__(
        self,
        scenes: Sequence[Sequence[str]],
        h: int,
        w: int,
        *,
        depth: int = 2,
        threads: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.scenes = [list(s) for s in scenes]
        self.h, self.w = h, w
        self.views = len(self.scenes[0]) if self.scenes else 0
        for s in self.scenes:
            if len(s) != self.views:
                raise ValueError("all scenes must have the same view count")
        self.device = None if device is None else torch.device(device)
        self._lib = _load()
        self.backend = "pil" if self._lib is None else "native"
        self._handle = None
        self._pool = None
        self._ahead = collections.deque()  # PIL: each scene's views' futures
        self._submitted = 0
        nthreads = threads or min(self.views, os.cpu_count() or 1)
        if self._lib is not None and self.scenes:
            flat = [p for s in self.scenes for p in s]
            offsets = np.zeros(len(self.scenes) + 1, np.int32)
            np.cumsum([len(s) for s in self.scenes], out=offsets[1:])
            self._flat = (ctypes.c_char_p * len(flat))(*[p.encode() for p in flat])
            self._offsets = offsets  # keep alive while the decoder reads it
            self._handle = self._lib.mvs_prefetcher_create(
                self._flat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                len(self.scenes), h, w, depth, nthreads,
            )
        elif self.scenes:
            self._pool = ThreadPoolExecutor(max(1, nthreads), thread_name_prefix="scene-decode")
            for _ in range(max(1, depth)):
                self._submit_next()
        self._staging = []
        if self.device is not None and self.device.type == "cuda":
            shape = (self.views, h, w, 3)
            self._staging = [
                (torch.empty(shape, dtype=torch.uint8, pin_memory=True), torch.cuda.Event())
                for _ in range(STAGING_BUFFERS)
            ]

    def _submit_next(self) -> None:
        if self._submitted < len(self.scenes):
            paths = self.scenes[self._submitted]
            self._ahead.append([self._pool.submit(_pil_decode, p) for p in paths])
            self._submitted += 1

    def _buffer(self, k: int) -> np.ndarray:
        """Where scene ``k`` is decoded: a new array, or a pinned buffer once
        the copy that last read it has finished."""
        if not self._staging:
            return np.empty((self.views, self.h, self.w, 3), np.uint8)
        pinned, copied = self._staging[k % len(self._staging)]
        copied.synchronize()
        return pinned.numpy()

    def _decode_into(self, buf: np.ndarray, k: int) -> int | None:
        """Fill ``buf`` with the next scene; its index, or None at the end."""
        if self._handle is None:  # PIL decodes, ``depth`` scenes ahead
            views = self._ahead.popleft()
            self._submit_next()
            for v, fut in enumerate(views):
                arr = fut.result()
                if arr.shape != buf.shape[1:]:
                    raise ValueError(f"{self.scenes[k][v]} is {arr.shape}, expected {buf.shape[1:]}")
                buf[v] = arr
            return k
        rc = self._lib.mvs_prefetcher_next(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        )
        if rc == -1:
            return None
        if rc < -1:
            bad = -(rc + 1) - 100
            raise IOError(f"prefetcher: decode failed (image {bad})")
        return rc

    def _deliver(self, buf: np.ndarray, k: int):
        if self.device is None:
            return buf
        if not self._staging:
            return torch.from_numpy(buf).to(self.device)
        pinned, copied = self._staging[k % len(self._staging)]
        with torch.cuda.device(self.device):
            out = torch.empty(pinned.shape, dtype=torch.uint8, device=self.device)
            out.copy_(pinned, non_blocking=True)
            copied.record(torch.cuda.current_stream(self.device))
        return out

    def __iter__(self) -> Iterator[tuple[int, np.ndarray | torch.Tensor]]:
        for k in range(len(self.scenes)):
            buf = self._buffer(k)
            idx = self._decode_into(buf, k)
            if idx is None:
                return
            yield idx, self._deliver(buf, k)

    def close(self) -> None:
        if self._handle is not None and self._lib is not None:
            self._lib.mvs_prefetcher_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._ahead.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_scenes(pipe, scene_lists: Sequence[str], *, depth: int = 2):
    """Streaming executor: decode ahead with the native prefetcher while
    ``pipe.jitted()`` runs each scene on the pipeline's device.
    ``scene_lists`` are data.txt paths; yields (scene_index,
    PipelineArtifacts)."""
    scenes = [read_image_list(p) for p in scene_lists]
    fwd = pipe.jitted()
    with ScenePrefetcher(
        scenes, pipe.geom.img_h, pipe.geom.img_w, depth=depth, device=pipe.device
    ) as pf:
        for idx, rgb in pf:
            yield idx, fwd(rgb)
