"""The plain reference, the capture generator and the control: the
reference is the port's CPU path bit for bit on a tiny capture, the
generator repeats from its seed, and the control (the reference in
bfloat16) fails a limit of every cell."""

from __future__ import annotations

import json

import pytest
import torch

from mvs_bench import harness, judge, reference, scenes
from mvs_bench.tests.conftest import BENCH

H, W = 64, 96


def _settings(**over) -> dict:
    cfg = json.loads((BENCH / "configs/clmvde-3x3-1080p.json").read_text())
    return {**cfg["settings"], **over}


def _capture(seed: int = 5, rig=(3, 3), device="cpu", traffic="offline") -> torch.Tensor:
    tr = json.loads((BENCH / f"traffic/{traffic}.json").read_text())
    return scenes.render(seed, 0, rig, H, W, 1.0359, tr["scene"], tr["disparity"]["lo"], tr["disparity"]["hi"],
                         device)


def test_the_generator_repeats_exactly_from_a_seed():
    big = 2**31 + 2**20 + 17
    a, b, c = _capture(big), _capture(big), _capture(big + 1)
    assert a.dtype == torch.uint8 and a.shape == (9, H, W, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert scenes.layout(big, 3, H, W, json.loads((BENCH / "traffic/offline.json").read_text())["scene"], 30, 60) \
        == scenes.layout(big, 3, H, W, json.loads((BENCH / "traffic/offline.json").read_text())["scene"], 30, 60)


@pytest.mark.parametrize("traffic", ["offline", "near"])
def test_every_scene_holds_its_counts_and_disparities_in_range(traffic):
    tr = json.loads((BENCH / f"traffic/{traffic}.json").read_text())
    lo, hi = tr["disparity"]["lo"], tr["disparity"]["hi"]
    for seed in (1, 2**33 + 5):
        for i in range(tr["pool"]):
            geo = scenes.layout(seed, i, 1080, 1920, tr["scene"], lo, hi)
            assert len(geo["rects"]) == tr["scene"]["rects_min"] + i % 4
            bg = [geo["a"] + sx * geo["bx"] * 960 + sy * geo["by"] * 540 for sx in (-1, 1) for sy in (-1, 1)]
            assert all(lo <= d <= hi for d in bg + [r[4] for r in geo["rects"]])


def _port_cpu(rgb, settings: dict):
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    art = MVSPipeline.create(W, H, SystemSettings.from_dict(settings), device="cpu").run(rgb)
    return harness.artifacts(art, art.disp_full)


@pytest.mark.parametrize("rig,over", [((3, 3), {}), ((5, 3), {"array_width": 5}),
                                      ((3, 3), {"min_disp": 0, "max_disp": 40})])
def test_the_reference_is_the_ports_cpu_path_bit_for_bit(rig, over):
    st = _settings(**over)
    rgb = _capture(11, rig)
    got = _port_cpu(rgb, st)
    want = reference.run(rgb, reference.Settings.from_dict(st))
    for k, t in got.items():
        assert torch.equal(torch.nan_to_num(t.float()), torch.nan_to_num(getattr(want, k).float())), k
    assert all(v == 0.0 for v in judge.compare(got, want).values())


def test_the_reference_refuses_settings_it_does_not_implement():
    with pytest.raises(ValueError):
        reference.Settings.from_dict(_settings(edge_enable=True))


@pytest.mark.parametrize("cell", ["rig3x3.offline", "rig3x5.offline", "rig3x3.near", "rig3x3.live"])
def test_the_control_in_bfloat16_fails_a_limit_of_the_cell(cell):
    limits = json.loads((BENCH / f"limits/{cell}.json").read_text())
    st = reference.Settings.from_dict(_settings())
    rgb = _capture(3)
    want = reference.run(rgb, st)
    low = reference.run(rgb, st, lowp=True)
    nums = judge.compare(low._asdict(), want)
    assert any(nums[k] > limits[k] for k in judge.NUMBERS), nums


@pytest.mark.cuda
def test_the_port_on_the_card_keeps_within_the_limits(card):
    st = _settings()
    rgb = _capture(21, device=card)
    from cl_multiview_stereo_tpu_torch.config import SystemSettings
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline

    art = MVSPipeline.create(W, H, SystemSettings.from_dict(st), device=card).jitted()(rgb.cpu())
    nums = judge.compare(harness.artifacts(art, art.disp_full), reference.run(rgb, reference.Settings.from_dict(st)))
    limits = json.loads((BENCH / "limits/rig3x3.offline.json").read_text())
    assert all(nums[k] <= limits[k] for k in judge.NUMBERS), nums
