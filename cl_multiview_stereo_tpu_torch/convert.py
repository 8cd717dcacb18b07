"""Stage artifacts from numpy into the port's tensors.

The pipeline has no weights; its state is the stage artifacts.  These
helpers carry the JAX package's arrays (as numpy, keyed as
``utils/artifacts.save_checkpoint`` and ``MVSPipeline._validate_checkpoint``
key them) into the port with explicit dtypes, so that a port stage can be
fed the JAX stage's own inputs and judged apart from upstream ulps.

Keys: ``labels`` (V, H, W); ``center`` (V, Mh, Mw, 2); ``color``
(V, Mh, Mw, 3); ``count`` (V, Mh, Mw), optional as in the JAX pipeline's
re-entry; ``disp_init`` (V, Mh, Mw); ``state_d``/``state_sm``/``state_cs``
(V, Mh, Mw); ``state_n`` (V, Mh, Mw, 3); and, for ``make_context``, the
artifact names ``extent`` (V, Mh, Mw, 8) and ``flatness`` (V, Mh, Mw, 2).

The SfM stages' inputs come as the JAX package's named tuples (any object
with the same fields, arrays or numpy): ``keypoints``, ``matches``,
``ba_problem`` and ``pose_graph``, ids as int32 and everything else as
float32 (``valid`` as bool).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.models import sfm
from cl_multiview_stereo_tpu_torch.ops import features, refine, slic


def tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous copy of ``a`` with exactly ``dtype`` on ``device``
    (``torch.from_numpy`` would keep float64 where JAX gives float32)."""
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype).contiguous()


def labels(ck: Mapping, device) -> torch.Tensor:
    return tensor(ck["labels"], torch.int32, device)


def superpixel_map(ck: Mapping, device) -> slic.SuperpixelMap:
    """``center``/``color``/``count``; a missing ``count`` and ``disp``
    start at zero, as the JAX pipeline re-enters them."""
    center = tensor(ck["center"], torch.float32, device)
    zeros = torch.zeros(center.shape[:3], dtype=torch.float32, device=device)
    return slic.SuperpixelMap(
        center=center,
        color=tensor(ck["color"], torch.float32, device),
        count=tensor(ck["count"], torch.float32, device) if "count" in ck else zeros,
        disp=zeros.clone(),
    )


def disp_init(ck: Mapping, device) -> torch.Tensor:
    return tensor(ck["disp_init"], torch.float32, device)


def refine_state(ck: Mapping, device) -> refine.RefineState:
    return refine.RefineState(
        d=tensor(ck["state_d"], torch.float32, device),
        sm=tensor(ck["state_sm"], torch.float32, device),
        cs=tensor(ck["state_cs"], torch.float32, device),
        n=tensor(ck["state_n"], torch.float32, device),
    )


def checkpoint(ck: Mapping, device) -> dict:
    """The stage groups of a checkpoint (``MVSPipeline._validate_checkpoint``'s),
    each converted once and only when the JAX pipeline's re-entry takes it:
    ``labels`` and ``spmap`` when ``labels`` and ``center`` are there,
    ``disp_init``, and ``state`` when ``state_d`` is there.  Other keys
    (``disp_full``, which fusion recomputes) are left out."""
    out = {}
    if "labels" in ck and "center" in ck:
        out["labels"] = labels(ck, device)
        out["spmap"] = superpixel_map(ck, device)
    if "disp_init" in ck:
        out["disp_init"] = disp_init(ck, device)
    if "state_d" in ck:
        out["state"] = refine_state(ck, device)
    return out


def context_inputs(ck: Mapping, device) -> dict[str, torch.Tensor]:
    """Keyword tensors for ``refine.make_context``."""
    return dict(
        center=tensor(ck["center"], torch.float32, device),
        color=tensor(ck["color"], torch.float32, device),
        disp0=disp_init(ck, device),
        labels=labels(ck, device),
        extent=tensor(ck["extent"], torch.int32, device),
        fl=tensor(ck["flatness"], torch.float32, device),
    )


def keypoints(kp, device) -> features.Keypoints:
    return features.Keypoints(
        xy=tensor(kp.xy, torch.float32, device),
        score=tensor(kp.score, torch.float32, device),
        desc=tensor(kp.desc, torch.float32, device),
    )


def matches(m, device) -> features.Matches:
    return features.Matches(idx=tensor(m.idx, torch.int32, device), valid=tensor(m.valid, torch.bool, device))


def ba_problem(p, device) -> sfm.BAProblem:
    ids = ("obs_cam", "obs_pt")
    return sfm.BAProblem(**{
        f: tensor(getattr(p, f), torch.int32 if f in ids else torch.float32, device)
        for f in sfm.BAProblem._fields
    })


def pose_graph(g, device) -> sfm.PoseGraph:
    return sfm.PoseGraph(
        edges=tensor(g.edges, torch.int32, device),
        rel_aa=tensor(g.rel_aa, torch.float32, device),
        rel_t=tensor(g.rel_t, torch.float32, device),
        w_rot=tensor(g.w_rot, torch.float32, device),
        w_t=tensor(g.w_t, torch.float32, device),
        info=None if g.info is None else tensor(g.info, torch.float32, device),
    )
