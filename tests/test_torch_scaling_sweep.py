"""The port's scaling sweep (``tools/scaling_sweep``, the twin of
tools/scaling_sweep.py) on the CPU: gloo ranks at 1 and 2 of 24x32, one
line per rank count with finite views/s, every rank's ``disp_full``
bitwise the unsharded run; ``--device cuda`` without a card raises before
any rank starts."""

import json
import math

import pytest

from cl_multiview_stereo_tpu_torch.tools import ranks, scaling_sweep


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep") / "sweep.json"
    return scaling_sweep.main(["--device", "cpu", "--n", "2", "--hw", "24x32", "--json", str(out)]), out


def test_one_line_per_rank_count(sweep, capsys):
    results, out = sweep
    assert [r["devices"] for r in results] == [1, 2]
    assert [r["views"] for r in results] == [2, 4]  # 2 views a rank
    for r in results:
        assert math.isfinite(r["views_per_s"]) and r["views_per_s"] > 0
        assert r["per_device"] == r["views_per_s"] / r["devices"]
        assert r["views_per_s"] == r["views"] / r["median_s"] and len(r["runs_s"]) == scaling_sweep.RUNS
        assert r["backend"] == "gloo" and r["card"] == "cpu" and r["hw"] == "24x32"
    assert results[0]["efficiency"] == 1.0
    assert results[1]["efficiency"] == results[1]["per_device"] / results[0]["per_device"]
    assert json.loads(out.read_text()) == results


def test_every_rank_is_bitwise_the_unsharded_run(sweep):
    """The tool raises unless every rank's check passed; the records say so."""
    results, _ = sweep
    assert all(r["bitwise"] for r in results)


def test_weak_scaling_settings():
    """The JAX tool's configuration: n x 2 views, 8-pixel superpixels,
    disparity 2..9, kernel 8 / step 2, two sweeps."""
    s = scaling_sweep.settings(4)
    assert (s.array_width, s.array_height, s.view_num) == (4, 2, 8)
    assert (s.spixl_size, s.min_disp, s.max_disp, s.inc, s.bl_ratio) == (8, 2, 9, 1, 1.0)
    assert (s.kernel_size, s.kernel_step, s.no_prop) == (8, 2, 2)


def test_cuda_without_a_card_raises_before_any_rank(monkeypatch, capsys):
    def no_spawn(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(ranks, "spawn", no_spawn)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        scaling_sweep.main(["--device", "cuda", "--n", "2", "--hw", "24x32"])
    assert capsys.readouterr().out == ""
