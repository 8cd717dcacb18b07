"""Multi-view image-array loading (a copy of
``cl_multiview_stereo_tpu/io/images.py``, numpy and PIL only, kept here so
that the port imports nothing of the JAX package).

The reference reads a newline-separated list of image paths from a text file
(``clMVDE/file_handler.cpp:30-57``, list format as in ``clMVDE/data.txt``)
and decodes each with OpenCV, yielding a camera-array's worth of equally
sized views.  We keep the same list format (paths relative to the list
file's directory, like the reference resolves them relative to its working
dir) and return one dense ``(V, H, W, 3)`` uint8 RGB array, ready to become
a device-resident batch — no per-view host loop.
"""

from __future__ import annotations

import os

import numpy as np


def read_image_list(list_path: str, view_num: int | None = None) -> list[str]:
    """Parse the reference's list format: one path per line, blank lines
    skipped (file_handler.cpp:30-44).  Relative paths resolve against the
    list file's directory."""
    base = os.path.dirname(os.path.abspath(list_path))
    paths: list[str] = []
    with open(list_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            paths.append(line if os.path.isabs(line) else os.path.normpath(os.path.join(base, line)))
    if view_num is not None:
        if len(paths) < view_num:
            raise ValueError(f"image list has {len(paths)} entries, need {view_num}")
        paths = paths[:view_num]
    return paths


def load_image(path: str) -> np.ndarray:
    """Decode one image to (H, W, 3) uint8 RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_image_array(list_path: str, view_num: int | None = None) -> np.ndarray:
    """Load the whole camera array as (V, H, W, 3) uint8 RGB.

    All views must share one shape (the reference assumes this implicitly by
    sizing every buffer from view 0, pipeline.cpp:15-16).
    """
    paths = read_image_list(list_path, view_num)
    imgs = [load_image(p) for p in paths]
    shape = imgs[0].shape
    for p, im in zip(paths, imgs):
        if im.shape != shape:
            raise ValueError(f"view shape mismatch: {p} is {im.shape}, expected {shape}")
    return np.stack(imgs, axis=0)


def draw_segmentation_lines(rgb: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Superpixel boundary overlay (``clSLIC::draw_segmentation_lines``,
    clSLIC.cpp:447-478): interior pixels whose label differs from any
    4-neighbor turn red (the reference writes BGR (0,0,255)).  The 1-px
    border, which the reference leaves uninitialized in its output buffer,
    passes the input through — the only defined choice.

    ``rgb``: (H, W, 3) or (V, H, W, 3) uint8; ``labels`` matching (H, W) /
    (V, H, W).  Returns the overlay, vectorized.
    """
    rgb = np.asarray(rgb)
    labels = np.asarray(labels)
    if rgb.ndim == 3:
        rgb, labels = rgb[None], labels[None]
        squeeze = True
    else:
        squeeze = False
    out = rgb.copy()
    c = labels[:, 1:-1, 1:-1]
    edge = (
        (c != labels[:, 1:-1, 2:])
        | (c != labels[:, 1:-1, :-2])
        | (c != labels[:, :-2, 1:-1])
        | (c != labels[:, 2:, 1:-1])
    )
    interior = out[:, 1:-1, 1:-1]
    interior[edge] = (255, 0, 0)  # red in RGB == the reference's BGR 0,0,255
    out[:, 1:-1, 1:-1] = interior
    return out[0] if squeeze else out


def save_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(np.asarray(img, dtype=np.uint8)).save(path)


def save_gray_png(path: str, img: np.ndarray, lo: float, hi: float) -> None:
    """Normalized grayscale dump, the reference's per-stage debug artifact
    (e.g. ``img_translate`` photo_consistency.cpp:414-438)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    x = np.asarray(img, dtype=np.float64)
    scaled = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    Image.fromarray((scaled * 255.0).astype(np.uint8)).save(path)
