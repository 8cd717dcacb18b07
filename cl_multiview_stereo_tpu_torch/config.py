"""Configuration layer (a copy of ``cl_multiview_stereo_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
names, fields, defaults and behaviour are the JAX module's, so a settings
JSON written by either package loads in the other
(``tests/test_torch_config.py`` holds the two equal).

The reference hardcodes every tunable in ``main()`` (``clMVDE/clMVDE.cpp:12-41``)
into one ``system_settings`` struct (``clMVDE/header.h:55-77``) with no file,
CLI, or env override.  This module keeps the exact same knob set (so any
reference configuration maps 1:1) but makes it a frozen dataclass with
JSON-file and dict overrides, plus the *derived* quantities the reference
computes at scattered call sites:

* disparity ladder (``clMVDE/pipeline.cpp:121-124``),
* per-view neighbor subsets from camera-grid adjacency
  (``clMVDE/pipeline.cpp:130-142``),
* map size ``ceil(img / spixl_size)`` (``clMVDE/pipeline.cpp:18-19``),
* SLIC distance normalizers (``clMVDE/clSLIC.cpp:15-18``),
* the refinement-engine parameter transforms
  (``clMVDE/pipeline.cpp:164-166`` + ``depth_refinement.cpp:330-339,734-739``):
  host passes ``2*gamma^2`` / ``2*alpha^2`` and ``kernel_size/2``; the engine
  then inverts to ``1/(2*gamma^2)`` etc. and computes
  ``sp_kernel_step = max(1, (kernel_size//kernel_step)*spixl_size)`` with C++
  integer division, ``fuse_eff = 0.5*fuse``; each propagation iteration decays
  reach as ``no_kernel_steps//(iter+1)`` (int) and
  ``kernel_step_size/(iter+1)`` (float).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SystemSettings:
    """Mirror of ``system_settings`` (``clMVDE/header.h:55-77``).

    Defaults are the values hardcoded in ``main()`` (``clMVDE/clMVDE.cpp:14-36``).
    """

    # --- SLIC segmentation ---
    spixl_size: int = 8
    slic_color_weight: float = 0.6  # weights the *spatial* term, see clcode.cl:433
    no_iter: int = 5
    enforce_connectivity: bool = False
    edge_enable: bool = False

    # --- camera array geometry ---
    array_width: int = 3
    array_height: int = 3
    neib_hor: int = 1
    neib_ver: int = 1
    bl_ratio: float = 1.03590  # vertical/horizontal baseline ratio, clcode.cl:1034

    # --- disparity ladder ---
    num_disp_levels: int = 30  # informational; ladder length is derived below
    min_disp: int = 30
    max_disp: int = 60
    inc: int = 1

    # --- refinement ---
    kernel_size: int = 1080
    kernel_step: int = 13
    fuse: float = 1.0
    gamma: float = 2.0
    alpha: float = 6.0
    no_prop: int = 5

    # --- SfM front-end (north-star extension; absent from the reference) ---
    # focal length in pixels (fx = fy); None -> the f = max(h, w) FOV prior
    sfm_focal: float | None = None
    # metric scale of one camera-grid step (the BA gauge + pair-delta unit)
    sfm_baseline: float = 1.0

    @property
    def view_num(self) -> int:
        return self.array_width * self.array_height

    # ------------------------------------------------------------------ I/O
    def replace(self, **kw: Any) -> "SystemSettings":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SystemSettings":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown settings keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, path: str) -> "SystemSettings":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------


def map_size_for(img_w: int, img_h: int, spixl_size: int) -> tuple[int, int]:
    """Superpixel-grid dims: ``ceil(img / spixl_size)`` (clMVDE/pipeline.cpp:18-19).

    Returns (map_w, map_h).
    """
    return (
        int(math.ceil(img_w / float(spixl_size))),
        int(math.ceil(img_h / float(spixl_size))),
    )


def build_disp_levels(s: SystemSettings) -> np.ndarray:
    """Disparity hypothesis ladder ``min + i*inc`` for i in 0..(max-min)//inc
    *inclusive* (clMVDE/pipeline.cpp:121-124 — note the ``<=`` bound, so the
    default 30..60 step 1 config yields 31 levels, not ``num_disp_levels=30``).
    """
    n = (s.max_disp - s.min_disp) // s.inc + 1
    return np.asarray([s.min_disp + i * s.inc for i in range(n)], dtype=np.float32)


def build_view_subsets(s: SystemSettings) -> tuple[np.ndarray, np.ndarray]:
    """Per-view neighbor subsets from grid adjacency within ``neib_hor/ver``
    (clMVDE/pipeline.cpp:130-142).

    The reference stores them in a dense ``int[V*V]`` row-major table plus a
    count array (``depth_refinement.cpp:23-32``).  We keep the same dense
    layout, padded with -1, since fixed shapes are what XLA wants anyway.

    Returns ``(view_subset, subset_num)`` of shapes ``(V, V)`` int32 and
    ``(V,)`` int32.  The enumeration order matters for floating-point
    reduction parity: the C++ loops x (outer) then y (inner).
    """
    v = s.view_num
    subset = np.full((v, v), -1, dtype=np.int32)
    counts = np.zeros((v,), dtype=np.int32)
    for i in range(v):
        k = 0
        for x in range(i % s.array_width - s.neib_hor, i % s.array_width + s.neib_hor + 1):
            for y in range(i // s.array_width - s.neib_ver, i // s.array_width + s.neib_ver + 1):
                idx = y * s.array_width + x
                if 0 <= x < s.array_width and 0 <= y < s.array_height and idx != i:
                    subset[i, k] = idx
                    k += 1
        counts[i] = k
    return subset, counts


@dataclasses.dataclass(frozen=True)
class DerivedGeometry:
    """Static shape/geometry info shared by every stage."""

    img_w: int
    img_h: int
    map_w: int
    map_h: int
    view_num: int
    spixl_size: int

    @classmethod
    def create(cls, img_w: int, img_h: int, s: SystemSettings) -> "DerivedGeometry":
        mw, mh = map_size_for(img_w, img_h, s.spixl_size)
        return cls(
            img_w=img_w,
            img_h=img_h,
            map_w=mw,
            map_h=mh,
            view_num=s.view_num,
            spixl_size=s.spixl_size,
        )


@dataclasses.dataclass(frozen=True)
class SlicParams:
    """SLIC engine parameters derived at ``clMVDE/clSLIC.cpp:15-18``.

    ``max_xy_dist = (1/(1.4242*S))^2`` and ``max_color_dist = (15/(1.7321*128))^2``
    are the squared normalizers fed to the distance function (clcode.cl:422-438).
    """

    max_xy_dist: float
    max_color_dist: float
    color_weight: float
    spixl_size: int
    no_iter: int
    enforce_connectivity: bool
    edge_enable: bool

    @classmethod
    def create(cls, s: SystemSettings) -> "SlicParams":
        xy = 1.0 / (1.4242 * s.spixl_size)
        col = 15.0 / (1.7321 * 128.0)
        return cls(
            max_xy_dist=np.float32(np.float32(xy) * np.float32(xy)),
            max_color_dist=np.float32(np.float32(col) * np.float32(col)),
            color_weight=s.slic_color_weight,
            spixl_size=s.spixl_size,
            no_iter=s.no_iter,
            enforce_connectivity=s.enforce_connectivity,
            edge_enable=s.edge_enable,
        )


@dataclasses.dataclass(frozen=True)
class RefinementSchedule:
    """Effective refinement-engine parameters after the reference's transform
    chain (see module docstring).

    ``gamma_eff``/``alpha_eff`` multiply *squared* differences inside
    ``exp(-diff^2 * g)`` terms, ``sp_kernel_step`` is the long-range tap pitch
    in superpixels, and ``steps_per_iter``/``step_size_per_iter`` give the
    decayed reach used by propagation iteration ``iter``
    (``depth_refinement.cpp:767-769``).
    """

    gamma_eff: float
    alpha_eff: float
    fuse_eff: float
    kernel_steps: int
    sp_kernel_step: float
    no_prop: int
    bl_ratio: float
    steps_per_iter: tuple[int, ...]
    step_size_per_iter: tuple[float, ...]

    @classmethod
    def create(cls, s: SystemSettings) -> "RefinementSchedule":
        # pipeline.cpp:164-166
        gamma_host = 2.0 * s.gamma**2
        alpha_host = 2.0 * s.alpha**2
        kernel_size_half = s.kernel_size // 2
        # depth_refinement.cpp:330-339 / 734-739
        gamma_eff = 1.0 / gamma_host
        alpha_eff = 1.0 / alpha_host
        sp_kernel_step = float(max(1, (kernel_size_half // s.kernel_step) * s.spixl_size))
        fuse_eff = 0.5 * s.fuse
        steps = tuple(s.kernel_step // (i + 1) for i in range(s.no_prop))
        sizes = tuple(sp_kernel_step / (i + 1) for i in range(s.no_prop))
        return cls(
            gamma_eff=gamma_eff,
            alpha_eff=alpha_eff,
            fuse_eff=fuse_eff,
            kernel_steps=s.kernel_step,
            sp_kernel_step=sp_kernel_step,
            no_prop=s.no_prop,
            bl_ratio=s.bl_ratio,
            steps_per_iter=steps,
            step_size_per_iter=sizes,
        )


def camera_grid_coords(view_num: int, array_width: int) -> np.ndarray:
    """(V, 2) int32 array of (cam_x, cam_y) grid coordinates, the implicit
    camera model of the reference: ``camIdx = (z % W, z / W)`` (clcode.cl:1013).
    """
    z = np.arange(view_num, dtype=np.int32)
    return np.stack([z % array_width, z // array_width], axis=-1)
