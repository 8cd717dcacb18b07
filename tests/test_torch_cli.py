"""The port's CLI (``cl_multiview_stereo_tpu_torch.cli``) against the JAX
CLI on one 2x2 PNG scene: the results tree, the checkpoint keys, the point
cloud, the disparity, checkpoints resumed across the two packages, and the
SfM front-end (``sfm`` and ``run --sfm``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu import cli as jax_cli
from cl_multiview_stereo_tpu.io import images as jax_images
from cl_multiview_stereo_tpu.io import pointcloud as jax_pointcloud
from cl_multiview_stereo_tpu.models.mvs_pipeline import MVSPipeline as JaxPipeline
from cl_multiview_stereo_tpu_torch import cli
from cl_multiview_stereo_tpu_torch.io.images import load_image_array, save_png
from cl_multiview_stereo_tpu_torch.io.pointcloud import load_ply
from cl_multiview_stereo_tpu_torch.testing import synthetic
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.utils import artifacts
from torch_parity import CPU, jax_settings, n, small_settings

REPO = Path(__file__).resolve().parent.parent
# tests/torch_parity.small_settings as --set overrides (bl_ratio 1.0 and
# spixl_size 8 included)
SETS = [f"--set={k}={v}" for k, v in dict(
    array_width=2, array_height=2, min_disp=4, max_disp=11, bl_ratio=1.0,
    kernel_size=8, kernel_step=2, no_prop=2,
).items()]
FLAGS = ["--cross-check", "--checkpoint", "--ply", "--dump-stages"]
NPZ = "pipeline_state.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene as PNGs and a list file; one run of each CLI."""
    root = tmp_path_factory.mktemp("cli")
    views, _ = synthetic.two_plane_scene(
        48, 64, array_width=2, array_height=2, disp_bg=5.0, disp_fg=9.0, bl_ratio=1.0, seed=11
    )
    for i, im in enumerate(views):
        save_png(str(root / "img" / f"view_{i}.png"), im)
    lst = root / "data.txt"
    lst.write_text("".join(f"img/view_{i}.png\n" for i in range(len(views))))
    port_out, jax_out = root / "port", root / "jax"
    assert cli.main(["run", str(lst), "--device", "cpu", "--out", str(port_out), *FLAGS, *SETS]) == 0
    assert jax_cli.main(["run", str(lst), "--out", str(jax_out), *FLAGS, *SETS]) == 0
    return dict(root=root, list=str(lst), port=port_out, jax=jax_out,
                rgb=load_image_array(str(lst), 4), jrgb=jax_images.load_image_array(str(lst), 4))


def _tree(root: Path) -> set[str]:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def _npz(path: Path) -> dict[str, np.ndarray]:
    return artifacts.load_checkpoint(str(path))


def test_cli_writes_the_jax_tree(runs):
    tree = _tree(runs["port"])
    assert tree == _tree(runs["jax"])
    assert {"fused.ply", NPZ, "8- Fusion/disp_3.png", "0- segmentation/seg_0.png"} <= tree
    ck, jck = _npz(runs["port"] / NPZ), _npz(runs["jax"] / NPZ)
    assert set(ck) == set(jck)
    for k in ck:
        assert ck[k].shape == jck[k].shape and ck[k].dtype == jck[k].dtype, k
    pts, cols = load_ply(str(runs["port"] / "fused.ply"))
    assert pts.shape[0] == int((ck["disp_full"] > 1e-3).sum()) == cols.shape[0]
    jpts, _ = jax_pointcloud.load_ply(str(runs["jax"] / "fused.ply"))
    assert abs(pts.shape[0] - jpts.shape[0]) <= 0.02 * jpts.shape[0]


def test_cli_disparity_matches_jax(runs):
    """test_torch_pipeline.py's bounds, read from the two checkpoints."""
    ck, jck = _npz(runs["port"] / NPZ), _npz(runs["jax"] / NPZ)
    assert (ck["labels"] == jck["labels"]).mean() > 0.995
    assert (ck["disp_init"] == jck["disp_init"]).mean() >= 0.99
    close = (np.abs(ck["disp_full"] - jck["disp_full"]) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"
    assert (ck["disp_full"] == 0).any(), "the cross-check vote rejected nothing"


def test_port_checkpoint_resumes_in_jax(runs):
    """The post-refinement checkpoint re-enters at fusion; only the
    rasterizer's FMA contraction in XLA differs (ROADMAP queue 3)."""
    ck = _npz(runs["port"] / NPZ)
    art = JaxPipeline.create(64, 48, jax_settings(small_settings()), cross_check=True).resume(
        runs["jrgb"], str(runs["port"] / NPZ)
    )
    np.testing.assert_allclose(np.asarray(art.disp_full), ck["disp_full"], rtol=0, atol=5e-6)


def test_jax_cli_checkpoint_resumes_in_port(runs):
    jck = _npz(runs["jax"] / NPZ)
    art = MVSPipeline.create(64, 48, small_settings(), device=CPU, cross_check=True).resume(
        runs["rgb"], str(runs["jax"] / NPZ)
    )
    np.testing.assert_allclose(n(art.disp_full), jck["disp_full"], rtol=0, atol=5e-6)


def test_cli_resume_is_bitwise(runs):
    out = runs["root"] / "port_resume"
    args = ["run", runs["list"], "--device", "cpu", "--out", str(out), "--cross-check",
            "--checkpoint", "--resume", str(runs["port"] / NPZ), *SETS]
    assert cli.main(args) == 0
    np.testing.assert_array_equal(_npz(out / NPZ)["disp_full"], _npz(runs["port"] / NPZ)["disp_full"])
    assert (out / "8- Fusion" / "disp_0.png").is_file()


@pytest.mark.parametrize("argv", [["run", "--sfm", "--checkpoint"], ["sfm"]], ids=["--sfm", "sfm"])
def test_cli_sfm_matches_jax(runs, argv, tmp_path):
    """``sfm`` and ``run --sfm`` through both CLIs on the scene: the same
    ``sfm_poses.npz`` keys with the poses within
    tests/test_torch_sfm_pipeline.py's run_sfm bound (1e-5), and the
    disparity from the recovered pair deltas at test_torch_pipeline.py's
    bounds."""
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    assert cli.main([argv[0], runs["list"], "--device", "cpu", "--out", str(port_out), *argv[1:], *SETS]) == 0
    assert jax_cli.main([argv[0], runs["list"], "--out", str(jax_out), *argv[1:], *SETS]) == 0
    if argv[0] == "sfm":
        with np.load(port_out / "sfm_poses.npz") as got, np.load(jax_out / "sfm_poses.npz") as want:
            assert set(got.files) == set(want.files)
            for k in got.files:
                assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got["intr"], want["intr"])
        return
    ck, jck = _npz(port_out / NPZ), _npz(jax_out / NPZ)
    assert (ck["labels"] == jck["labels"]).mean() > 0.995
    assert (ck["disp_init"] == jck["disp_init"]).mean() >= 0.99
    close = (np.abs(ck["disp_full"] - jck["disp_full"]) <= 1e-3).mean()
    assert close >= 0.98, f"disp_full within 1e-3 on {close}"


def test_cli_default_device_needs_a_gpu(runs, monkeypatch, tmp_path):
    """``--device`` defaults to cuda and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        cli.main(["run", runs["list"], "--out", str(tmp_path), *SETS])
    assert not any(tmp_path.iterdir())


def test_cli_module_entry_point(runs, tmp_path):
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "cl_multiview_stereo_tpu_torch.cli", "run", runs["list"],
         "--device", "cpu", "--out", str(out), *SETS],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "loaded 4 views of 64x48" in proc.stdout
    assert len(list((out / "8- Fusion").glob("disp_*.png"))) == 4


def test_run_from_list_is_the_cli_pipeline(runs):
    pipe = MVSPipeline.create(64, 48, small_settings(), device=CPU, cross_check=True)
    art = pipe.run_from_list(runs["list"])
    np.testing.assert_array_equal(n(art.disp_full), _npz(runs["port"] / NPZ)["disp_full"])
    with pytest.raises(ValueError, match="pipeline built for 80x48"):
        MVSPipeline.create(80, 48, small_settings(), device=CPU).run_from_list(runs["list"])
