"""The multi-view depth pipeline (port of
``cl_multiview_stereo_tpu/models/mvs_pipeline.py``).

  RGB -> Lab -> SLIC -> superpixel extent -> plane-sweep depth init ->
  flatness -> state init -> PatchMatch propagation x no_prop -> fusion
  (plane rasterization [+ the cross-view vote])

All state stays on ``device``; the host touches only the input images and
whatever the caller pulls from the returned artifacts.  ``jitted()`` is the
one-program forward: on a card, ``run`` captured once into a CUDA graph and
replayed per scene.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.config import (
    DerivedGeometry,
    RefinementSchedule,
    SlicParams,
    SystemSettings,
    build_disp_levels,
    build_view_subsets,
)
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.device import device_table
from cl_multiview_stereo_tpu_torch.ops import (
    chain,
    color,
    consistency,
    cost_volume,
    crosscheck,
    fusion,
    raster,
    refine,
    slic,
    smoothness,
    superpixel,
)
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab
from cl_multiview_stereo_tpu_torch.utils.timing import StageTimer, maybe_stage


# Kernel launches made by replays of the CUDA graphs of ``jitted()``, by
# kernel: each replay adds the launches that its capture recorded.  The
# kernels' own ``LAUNCHES`` count a captured launch once, at capture.
REPLAYED_LAUNCHES: dict[str, int] = {}


def launch_counts() -> dict[str, int]:
    """Each hand kernel of ``run``: its launches so far, by name."""
    return {**color.LAUNCHES, "cost_volume": cost_volume.LAUNCHES, "consistency": consistency.LAUNCHES,
            **slic.LAUNCHES, **superpixel.LAUNCHES, **smoothness.LAUNCHES, **raster.LAUNCHES, **chain.LAUNCHES,
            **crosscheck.LAUNCHES}


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
    # volume); "gather" is the JAX module's direct gather form, plain
    # PyTorch.  JAX's dense_wide_rows (off under pair_layout="view") only
    # lays the dense form out for TPU memory and has no counterpart here.
    depth_method: str = "dense"
    # "packed" or "view": JAX's refinement pair axis layouts, bitwise
    # equal; the port scores either with the packed scorer, and its
    # view-sharded run (parallel/sharded_pipeline) filters the pairs to each
    # rank's own views, the view layout's job in JAX
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
        cost_volume.check_method(kw.get("depth_method", "dense"))
        refine.check_options(pair_layout=kw.get("pair_layout", "packed"))
        return cls(
            settings=s,
            geom=DerivedGeometry.create(img_w, img_h, s),
            device=torch.device(device),
            **kw,
        )

    def run(
        self,
        rgb: np.ndarray | torch.Tensor,
        timer: StageTimer | None = None,
        _ckpt: dict | None = None,
    ) -> PipelineArtifacts:
        """Full pipeline on a (V, H, W, 3) uint8 RGB camera-array batch.
        ``timer`` (CUDA only) records each stage's device time.

        ``_ckpt``: an optional checkpoint dict (``utils.artifacts.load_checkpoint``;
        ``resume()`` is the public wrapper).  Lab and the extent are always
        recomputed; each later stage group is taken from the checkpoint
        when the whole group is there, as the JAX pipeline re-enters."""
        s = self.settings
        geom = self.geom
        dev = self.device
        sched = RefinementSchedule.create(s)
        disp_levels = build_disp_levels(s)
        view_subset_np, subset_num_np = build_view_subsets(s)
        subset_num = device_table(subset_num_np, torch.int32, dev)
        ck = convert.checkpoint(_ckpt or {}, dev)
        rgb = torch.as_tensor(rgb, device=dev)

        with maybe_stage(timer, "lab"):
            lab = rgb_to_lab(rgb)
        if "spmap" in ck:
            labels, spmap = ck["labels"], ck["spmap"]
        else:
            with maybe_stage(timer, "slic"):
                labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
        with maybe_stage(timer, "extent"):
            extent = superpixel.superpixel_extent(labels, spmap.center, geom)
        if "disp_init" in ck:
            disp_init = ck["disp_init"]
        else:
            with maybe_stage(timer, "depth_init"):
                disp_init = cost_volume.initial_depth_estimation(
                    lab, spmap.center, extent, disp_levels, view_subset_np, subset_num,
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
        if "state" in ck:
            state = ck["state"]
        else:
            state = refine.refine(
                ctx, sched, pairs=pairs, pair_layout=self.pair_layout, timer=timer,
            )
        with maybe_stage(timer, "fusion"):
            disp_full = fusion.fuse_views(
                labels, spmap.center, state.d, state.n, array_width=s.array_width,
                bl_ratio=s.bl_ratio, fuse=sched.fuse_eff, cross_check=self.cross_check,
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

    def resume(
        self,
        rgb: np.ndarray | torch.Tensor,
        checkpoint_path: str,
        timer: StageTimer | None = None,
    ) -> PipelineArtifacts:
        """Re-enter the pipeline from a saved checkpoint
        (``utils.artifacts.save_checkpoint``, CLI ``--checkpoint``; the JAX
        package writes the same keys): the deepest stage whose outputs the
        npz holds is skipped, everything after it recomputes.  With a full
        post-refinement checkpoint only fusion runs; with a post-SLIC one
        (labels/center/color) depth init onward runs."""
        from cl_multiview_stereo_tpu_torch.utils.artifacts import load_checkpoint

        ck = load_checkpoint(checkpoint_path)
        self._validate_checkpoint(ck, checkpoint_path)
        return self.run(rgb, timer=timer, _ckpt=ck)

    def _validate_checkpoint(self, ck: dict, path: str) -> None:
        """Fail fast on partial key groups or arrays from a different
        scene/config: a stage re-enters only when its WHOLE output group is
        present, and every present array must match this pipeline's static
        geometry."""
        g = self.geom
        v, mh, mw, h, w = g.view_num, g.map_h, g.map_w, g.img_h, g.img_w
        groups = {
            "SLIC": (("labels", (v, h, w)), ("center", (v, mh, mw, 2)),
                     ("color", (v, mh, mw, 3))),
            "depth-init": (("disp_init", (v, mh, mw)),),
            "refinement": (("state_d", (v, mh, mw)), ("state_sm", (v, mh, mw)),
                           ("state_cs", (v, mh, mw)), ("state_n", (v, mh, mw, 3))),
        }
        for stage, keys in groups.items():
            present = [k for k, _ in keys if k in ck]
            if present and len(present) < len(keys):
                missing = [k for k, _ in keys if k not in ck]
                raise ValueError(
                    f"checkpoint '{path}': partial {stage} group — has "
                    f"{present}, missing {missing}; cannot resume this stage"
                )
            for k, shape in keys:
                if k in ck and tuple(np.shape(ck[k])) != shape:
                    raise ValueError(
                        f"checkpoint '{path}': '{k}' has shape "
                        f"{tuple(np.shape(ck[k]))} but this pipeline "
                        f"(views={v}, {w}x{h}, map {mw}x{mh}) expects {shape} "
                        f"— wrong scene or settings?"
                    )

    def jitted(self) -> Callable[[np.ndarray | torch.Tensor], PipelineArtifacts]:
        """The one-program forward, JAX's ``jax.jit(self.run)``: a callable
        from a (V, H, W, 3) uint8 scene to :class:`PipelineArtifacts`.

        On a CUDA pipeline the first call runs ``run`` once eagerly on a
        side stream (the warm-up that a capture needs; it also builds the
        kernels and the device tables, the consistency kernel's pair tables
        among them), captures one ``run`` into a CUDA
        graph from a static input, and replays it; every later call copies
        the scene into the static input and replays.  The artifacts are
        clones of the graph's outputs, so that the next replay does not
        overwrite them.  A capture that fails raises: nothing falls back to
        the eager ``run``.  On a CPU pipeline it is ``run``.  Either way a
        scene of another shape raises ``ValueError``; there is no timer,
        since the graph has no stage boundaries."""
        if self.device.type == "cuda":
            return _GraphedRun(self)
        if self.device.type != "cpu":
            raise ValueError(f"no one-program forward for device {self.device}")

        def forward(rgb: np.ndarray | torch.Tensor) -> PipelineArtifacts:
            _check_scene(self.geom, rgb)
            return self.run(rgb)

        return forward

    def run_from_list(self, list_path: str) -> PipelineArtifacts:
        """Load the image list (the reference's ``data.txt`` format) and run."""
        from cl_multiview_stereo_tpu_torch.io.images import load_image_array

        rgb = load_image_array(list_path, self.settings.view_num)
        if rgb.shape[2] != self.geom.img_w or rgb.shape[1] != self.geom.img_h:
            raise ValueError(
                f"images are {rgb.shape[2]}x{rgb.shape[1]}, pipeline built for "
                f"{self.geom.img_w}x{self.geom.img_h}"
            )
        return self.run(rgb)


def _check_scene(geom: DerivedGeometry, rgb) -> None:
    want = (geom.view_num, geom.img_h, geom.img_w, 3)
    if tuple(rgb.shape) != want:
        raise ValueError(f"scene of shape {tuple(rgb.shape)}, the pipeline takes {want}")


def _map_tensors(fn, tree):
    """``fn`` on every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map_tensors(fn, x) for x in tree))


class _GraphedRun:
    """``MVSPipeline.jitted()`` on a card: ``run`` as one CUDA graph."""

    def __init__(self, pipe: MVSPipeline):
        self.pipe = pipe
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in: torch.Tensor | None = None
        self.static_out: PipelineArtifacts | None = None
        self.captured_launches: dict[str, int] = {}

    def _capture(self, rgb: torch.Tensor) -> None:
        dev = self.pipe.device
        self.static_in = torch.empty(rgb.shape, dtype=rgb.dtype, device=dev)
        self.static_in.copy_(rgb)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.pipe.run(self.static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph):
            self.static_out = self.pipe.run(self.static_in)
        self.captured_launches = {name: n - before[name] for name, n in launch_counts().items()}
        self.graph = graph

    def __call__(self, rgb: np.ndarray | torch.Tensor) -> PipelineArtifacts:
        _check_scene(self.pipe.geom, rgb)
        rgb = torch.as_tensor(rgb)
        with torch.cuda.device(self.pipe.device):
            if self.graph is None:
                self._capture(rgb)
            elif rgb.dtype != self.static_in.dtype:
                raise ValueError(f"scene of dtype {rgb.dtype}, the graph was captured for {self.static_in.dtype}")
            else:
                self.static_in.copy_(rgb, non_blocking=True)
            self.graph.replay()
            for name, n in self.captured_launches.items():
                REPLAYED_LAUNCHES[name] = REPLAYED_LAUNCHES.get(name, 0) + n
            return _map_tensors(torch.clone, self.static_out)
