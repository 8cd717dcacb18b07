"""The port's CUDA kernels against their plain twins, on a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
CUDA device every test here skips.
"""

import pytest
import torch

from cl_multiview_stereo_tpu.config import (
    DerivedGeometry,
    SlicParams,
    SystemSettings,
    build_disp_levels,
)
from cl_multiview_stereo_tpu.testing import synthetic
from cl_multiview_stereo_tpu_torch.ops import cost_volume, slic, superpixel
from cl_multiview_stereo_tpu_torch.ops.color import rgb_to_lab

# the JAX suite's bounds for strips against dense (tests/test_depth_init.py)
RTOL, ATOL, WTA_AGREE = 2e-7, 1e-3, 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(h, w, s, device):
    rgb, _ = synthetic.fronto_parallel_scene(
        h, w, s.array_width, s.array_height, disp=7.0, bl_ratio=s.bl_ratio, seed=5
    )
    geom = DerivedGeometry.create(w, h, s)
    lab = rgb_to_lab(torch.as_tensor(rgb, device=device))
    labels, spmap = slic.segment(lab, geom, SlicParams.create(s))
    ext = superpixel.superpixel_extent(labels, spmap.center, geom)
    return lab.contiguous(), spmap.center.contiguous(), superpixel.extent_step(ext).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(48, 64), (61, 45)], ids=str)
@pytest.mark.parametrize("bl_ratio", [1.0, 1.0359, 0.97])
def test_cost_volume_kernel_matches_reference(cuda, hw, bl_ratio):
    s = SystemSettings(array_width=3, array_height=3, min_disp=4, max_disp=11, bl_ratio=bl_ratio)
    lab, centers, step = _inputs(*hw, s, cuda)
    levels = build_disp_levels(s)
    args = (lab, centers, step, levels, s.array_width, bl_ratio)
    before = cost_volume.LAUNCHES
    got = cost_volume.superpixel_cost_volume(*args)
    torch.cuda.synchronize()
    assert cost_volume.LAUNCHES == before + 1
    want = cost_volume.cost_volume_reference(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    ones = torch.ones(lab.shape[0], device=cuda)
    agree = (cost_volume.wta_disparity(got, levels, ones)
             == cost_volume.wta_disparity(want, levels, ones)).float().mean().item()
    assert agree > WTA_AGREE


@pytest.mark.cuda
def test_cost_volume_wrapper_rejects_bad_input(cuda):
    s = SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11)
    lab, centers, step = _inputs(48, 64, s, cuda)
    levels = build_disp_levels(s)
    with pytest.raises(TypeError):
        cost_volume.superpixel_cost_volume(lab.double(), centers, step, levels, 2, 1.0)
    with pytest.raises(ValueError):
        cost_volume.superpixel_cost_volume(lab, centers.cpu(), step, levels, 2, 1.0)
    with pytest.raises(ValueError):
        cost_volume.superpixel_cost_volume(
            lab.transpose(1, 2), centers, step, levels, 2, 1.0
        )
