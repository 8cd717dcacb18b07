"""Stage artifacts from numpy into the port's tensors.

The pipeline has no weights; its state is the stage artifacts.  These
helpers carry the JAX package's arrays (as numpy, keyed as
``utils/artifacts.save_checkpoint`` and ``MVSPipeline._validate_checkpoint``
key them) into the port with explicit dtypes, so that a port stage can be
fed the JAX stage's own inputs and judged apart from upstream ulps.

Keys: ``labels`` (V, H, W); ``center`` (V, Mh, Mw, 2); ``color``
(V, Mh, Mw, 3); ``count`` (V, Mh, Mw); ``disp_init`` (V, Mh, Mw);
``state_d``/``state_sm``/``state_cs`` (V, Mh, Mw); ``state_n``
(V, Mh, Mw, 3); and, for ``make_context``, the artifact names ``extent``
(V, Mh, Mw, 8) and ``flatness`` (V, Mh, Mw, 2).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cl_multiview_stereo_tpu_torch.ops import refine, slic


def tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous copy of ``a`` with exactly ``dtype`` on ``device``
    (``torch.from_numpy`` would keep float64 where JAX gives float32)."""
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype).contiguous()


def labels(ck: Mapping, device) -> torch.Tensor:
    return tensor(ck["labels"], torch.int32, device)


def superpixel_map(ck: Mapping, device) -> slic.SuperpixelMap:
    """``center``/``color``/``count``; ``disp`` starts at zero, as the JAX
    pipeline re-enters it."""
    center = tensor(ck["center"], torch.float32, device)
    return slic.SuperpixelMap(
        center=center,
        color=tensor(ck["color"], torch.float32, device),
        count=tensor(ck["count"], torch.float32, device),
        disp=torch.zeros(center.shape[:3], dtype=torch.float32, device=device),
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
