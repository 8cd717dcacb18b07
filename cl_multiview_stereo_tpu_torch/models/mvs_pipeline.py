"""The multi-view depth pipeline (port of
``cl_multiview_stereo_tpu/models/mvs_pipeline.py``).

  RGB -> Lab -> SLIC -> superpixel extent -> plane-sweep depth init ->
  flatness -> state init -> PatchMatch propagation x no_prop -> fusion

All state stays on ``device``; the host touches only the input images and
whatever the caller pulls from the returned artifacts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu_torch.ops import cost_volume, fusion, refine, slic, superpixel
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer, maybe_stage


class PipelineArtifacts(NamedTuple):
    """Every stage output, as tensors on the pipeline's device."""

    lab: torch.Tensor  # (V, H, W, 3)
    labels: torch.Tensor  # (V, H, W)
    spmap: slic.SuperpixelMap
    extent: torch.Tensor  # (V, Mh, Mw, 8)
    disp_init: torch.Tensor  # (V, Mh, Mw)
    flatness: torch.Tensor  # (V, Mh, Mw, 2)
    state: refine.RefineState
    disp_full: torch.Tensor  # (V, H, W) fused per-pixel disparity


@dataclasses.dataclass(frozen=True)
class MVSPipeline:
    """Configured pipeline for a fixed geometry, bound to one device."""

    settings: SystemSettings
    geom: DerivedGeometry
    device: torch.device
    cross_check: bool = False
    # "strips" and "dense" are one function in the port (the CUDA cost
    # volume); "gather" is not ported yet
    depth_method: str = "dense"
    pair_layout: str = "packed"
    # static (ref, view, dvx, dvy) pair list; None = camera-grid deltas
    pair_deltas: tuple | None = None

    @classmethod
    def create(
        cls,
        img_w: int,
        img_h: int,
        settings: SystemSettings | None = None,
        *,
        device: str | torch.device,
        **kw,
    ) -> "MVSPipeline":
        s = settings or SystemSettings()
        if kw.get("depth_method", "dense") not in ("dense", "strips"):
            raise NotImplementedError(f"depth_method={kw['depth_method']!r} is not ported yet")
        if kw.get("cross_check", False):
            raise NotImplementedError("cross_check=True is not ported yet")
        if kw.get("pair_layout", "packed") != "packed":
            raise NotImplementedError(f"pair_layout={kw['pair_layout']!r} is not ported yet")
        return cls(
            settings=s,
            geom=DerivedGeometry.create(img_w, img_h, s),
            device=torch.device(device),
            **kw,
        )

    def run(
        self, rgb: np.ndarray | torch.Tensor, timer: StageTimer | None = None
    ) -> PipelineArtifacts:
        """Full pipeline on a (V, H, W, 3) uint8 RGB camera-array batch.
        ``timer`` (CUDA only) records each stage's device time."""
        s = self.settings
        geom = self.geom
        dev = self.device
        sched = RefinementSchedule.create(s)
        disp_levels = build_disp_levels(s)
        view_subset_np, subset_num_np = build_view_subsets(s)
        subset_num = torch.as_tensor(subset_num_np, dtype=torch.int32, device=dev)
        rgb = torch.as_tensor(rgb, device=dev)

        with maybe_stage(timer, "lab"):
            lab = rgb_to_lab(rgb)
        with maybe_stage(timer, "slic"):
            labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
        with maybe_stage(timer, "extent"):
            extent = superpixel.superpixel_extent(labels, spmap.center, geom)
        with maybe_stage(timer, "depth_init"):
            disp_init = cost_volume.initial_depth_estimation(
                lab, spmap.center, extent, disp_levels, subset_num,
                s.array_width, s.bl_ratio, method=self.depth_method,
                neib_hor=s.neib_hor, neib_ver=s.neib_ver,
            )
        with maybe_stage(timer, "context"):
            flatness = refine.compute_flatness(spmap.color, sched.gamma_eff)
            ctx = refine.make_context(
                spmap.center, spmap.color, disp_init, labels, extent, flatness
            )
        if self.pair_deltas is not None:
            pairs = self.pair_deltas
        else:
            pairs = refine.pairs_from_subsets(view_subset_np, s.array_width)
        state = refine.refine(
            ctx, sched, pairs=pairs, pair_layout=self.pair_layout, timer=timer,
        )
        with maybe_stage(timer, "fusion"):
            disp_full = fusion.fuse_views(
                labels, spmap.center, state.d, state.n, cross_check=self.cross_check
            )
        return PipelineArtifacts(
            lab=lab,
            labels=labels,
            spmap=spmap,
            extent=extent,
            disp_init=disp_init,
            flatness=flatness,
            state=state,
            disp_full=disp_full,
        )
