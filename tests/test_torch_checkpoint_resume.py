"""Checkpoint resume in the port: each resume point against the port's
straight run (bitwise), a post-SLIC checkpoint without ``count`` in both
packages, and ``_validate_checkpoint``'s refusals.  Checkpoints crossing
between the two packages' CLIs are in test_torch_cli.py."""

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu_torch import convert
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.utils import artifacts
from torch_parity import CPU, jax_settings, n, scenes, small_settings

SLIC_KEYS = ("labels", "center", "color", "count")
# the keys each resume point saves beyond SLIC's
RESUME_POINTS = {
    "post_slic": (),
    "depth_init": ("disp_init",),
    "refined": ("disp_init", "state_d", "state_sm", "state_cs", "state_n"),
}


@pytest.fixture(scope="module")
def straight():
    views, jviews = scenes(
        "two_plane_scene", 48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0,
        bl_ratio=1.0, seed=11,
    )
    pipe = MVSPipeline.create(64, 48, small_settings(), device=CPU, cross_check=True)
    return views, pipe, pipe.run(views), jviews


def _arrays(art) -> dict[str, np.ndarray]:
    """Every checkpoint key of the JAX CLI, from port artifacts."""
    return dict(
        labels=n(art.labels), center=n(art.spmap.center), color=n(art.spmap.color),
        count=n(art.spmap.count), disp_init=n(art.disp_init), state_d=n(art.state.d),
        state_sm=n(art.state.sm), state_cs=n(art.state.cs), state_n=n(art.state.n),
        disp_full=n(art.disp_full),
    )


@pytest.mark.parametrize("point", list(RESUME_POINTS))
def test_resume_matches_straight_run(tmp_path, straight, point):
    views, pipe, art, _ = straight
    arrays = _arrays(art)
    path = str(tmp_path / f"{point}.npz")
    artifacts.save_checkpoint(path, **{k: arrays[k] for k in SLIC_KEYS + RESUME_POINTS[point]})
    art2 = pipe.resume(views, path)
    for field in ("labels", "disp_init", "disp_full"):
        np.testing.assert_array_equal(n(getattr(art2, field)), n(getattr(art, field)), err_msg=field)
    for field in ("d", "sm", "cs", "n"):
        np.testing.assert_array_equal(n(getattr(art2.state, field)), n(getattr(art.state, field)))


def test_resume_without_count_matches_jax(tmp_path, straight):
    """The JAX pipeline treats ``count`` as optional (zeros); so does the
    port.  A post-SLIC checkpoint without it resumes in both, and the two
    agree at test_torch_pipeline.py's bounds."""
    views, pipe, art, jviews = straight
    arrays = _arrays(art)
    path = str(tmp_path / "no_count.npz")
    artifacts.save_checkpoint(path, **{k: arrays[k] for k in ("labels", "center", "color")})
    got = pipe.resume(views, path)
    want = JaxPipeline.create(64, 48, jax_settings(small_settings()), cross_check=True).resume(
        jviews, path
    )
    assert not n(got.spmap.count).any() and not np.asarray(want.spmap.count).any()
    np.testing.assert_array_equal(n(got.disp_full), n(art.disp_full))
    np.testing.assert_array_equal(n(got.labels), np.asarray(want.labels))
    assert (n(got.disp_init) == np.asarray(want.disp_init)).mean() >= 0.99
    close = (np.abs(n(got.disp_full) - np.asarray(want.disp_full)) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"


def test_convert_checkpoint_dtypes(straight):
    """Each whole stage group, once, with its dtype; ``disp_full`` and
    unknown keys are left out, and a missing ``count`` reads as zeros."""
    arrays = _arrays(straight[2])
    ck = convert.checkpoint({**arrays, "extra": np.zeros(3)}, CPU)
    assert set(ck) == {"labels", "spmap", "disp_init", "state"}
    assert ck["labels"].dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in (*ck["spmap"], ck["disp_init"], *ck["state"]))
    np.testing.assert_array_equal(n(ck["state"].n), arrays["state_n"])
    slic_only = convert.checkpoint({k: arrays[k] for k in ("labels", "center", "color")}, CPU)
    assert set(slic_only) == {"labels", "spmap"}
    assert not slic_only["spmap"].count.any()


@pytest.mark.parametrize("fault", ["partial", "shape"])
def test_validate_checkpoint_raises(tmp_path, straight, fault):
    views, pipe, art, _ = straight
    arrays = _arrays(art)
    if fault == "partial":
        keep = dict((k, arrays[k]) for k in SLIC_KEYS + ("state_d", "state_sm"))
        match = "partial refinement group"
    else:
        keep = {k: arrays[k] for k in SLIC_KEYS}
        keep["center"] = keep["center"][:, :-1]
        match = "'center' has shape"
    path = str(tmp_path / f"{fault}.npz")
    artifacts.save_checkpoint(path, **keep)
    with pytest.raises(ValueError, match=match):
        pipe.resume(views, path)
