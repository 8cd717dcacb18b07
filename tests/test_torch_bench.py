"""The port's measurement tools (``cl_multiview_stereo_tpu_torch/tools/``:
``bench``, ``profile_stages``, ``memcheck``, ``roofline``) on the CPU at a
tiny size: each record's fields and formulas, the slice cell's result
against ``MVSPipeline.run``, no device metric from a CPU run, every tool
refusing ``--device cuda`` without a card, the idle-gap naming, and
memcheck's ``key=val`` rule against the JAX tool's."""

import json
import statistics

import pytest
import torch

from cl_multiview_stereo_tpu import config as jax_config
from cl_multiview_stereo_tpu_torch.config import SystemSettings
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.tools import bench, memcheck, profile_stages, roofline
from torch_parity import CPU

SMALL = ["array_width=2", "array_height=2", "min_disp=4", "max_disp=11"]
H, W = 36, 64


def _small_settings() -> SystemSettings:
    return SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11)


@pytest.mark.parametrize("cell", bench.CELLS)
def test_bench_record_on_the_cpu(cell, capsys):
    argv = ["--device", "cpu", "--hw", f"{H}x{W}", "--runs", "2", "--cell", cell]
    rec = bench.main(argv + [w for kv in SMALL for w in ("--set", kv)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == rec
    assert {"metric", "value", "unit", "cell", "median_s", "min_s", "max_s", "runs_s", "peak_mem_gib",
            "stage_ms", "breakdown", "card", "settings", "hw"} <= set(rec)
    assert rec["cell"] == cell and rec["hw"] == f"{H}x{W}" and rec["card"] == "cpu"
    assert rec["peak_mem_gib"] is None and rec["stage_ms"] is None and rec["breakdown"] is None
    assert rec["settings"] == {"array_width": 2, "array_height": 2, "min_disp": 4, "max_disp": 11}
    runs = rec["runs_s"]
    assert len(runs) == 2 and rec["median_s"] == statistics.median(runs)
    assert rec["min_s"] == min(runs) and rec["max_s"] == max(runs)
    v = 4
    want = {
        "depth_mp_per_s": v * H * W / rec["median_s"] / 1e6,
        "cli_s_per_scene": rec["median_s"],
        "sfm_s_per_scene": rec["median_s"],
        "stream_views_per_s": 3 * v / rec["median_s"],
    }[rec["metric"]]
    assert rec["value"] == want
    # no kernel on the CPU
    assert rec["launches"] == {"cost_volume": 0, "sweep": 0, "consistency": 0, "slic_assign": 0, "slic_update": 0,
                               "slic_vote": 0}


def test_bench_slice_cell_equals_run(tmp_path):
    """The slice cell times ``pipe.jitted()``; its disparity is bitwise
    ``MVSPipeline.run``'s on the same scene."""
    s = _small_settings()
    cell = bench.make_cell("slice", s, H, W, CPU, str(tmp_path), SMALL)
    _, art = cell.run()
    want = MVSPipeline.create(W, H, s, device=CPU).run(profile_stages.scene(s, H, W))
    assert torch.equal(art.disp_full, want.disp_full)


@pytest.mark.parametrize("tool", [bench, profile_stages, memcheck, roofline])
def test_tools_refuse_cuda_without_a_card(tool):
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        tool.main(["--device", "cuda"])


def test_profile_stages_and_memcheck_on_the_cpu(capsys):
    """On the CPU both tools run their path and print no device metric."""
    rec = profile_stages.main(["--device", "cpu", "--cell", "strips", "--hw", f"{H}x{W}"]
                              + [w for kv in SMALL for w in ("--set", kv)])
    assert rec["card"] == "cpu" and rec["cell"] == "strips"
    assert rec["stage_ms"] is None and rec["total_ms"] is None and rec["breakdown"] is None
    assert memcheck.main([str(H), str(W), *SMALL, "--pair-layout", "view", "--device", "cpu"]) == 0
    mem = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mem["card"] == "cpu" and mem["views"] == 4 and mem["pair_layout"] == "view"
    assert mem["fits"] is None and mem["peak_allocated_gib"] is None and mem["total_gib"] is None


def test_idle_gaps_named_by_the_innermost_range():
    """A hand-made trace: device busy [0, 10), [12, 20), [15, 18) and
    [50, 60); host ranges "run" over all of it, "slic" [5, 30) and
    "propagate" [30, 70) with "accept" [45, 52) inside."""
    busy = [(12.0, 20.0), (0.0, 10.0), (50.0, 60.0), (15.0, 18.0)]
    ranges = [("run", 0.0, 80.0), ("slic", 5.0, 30.0), ("propagate", 30.0, 70.0), ("accept", 45.0, 52.0)]
    gaps = profile_stages.idle_gaps(busy, ranges, (0.0, 80.0), n=5)
    assert gaps == [(20.0, 50.0, "slic"), (60.0, 80.0, "propagate"), (10.0, 12.0, "slic")]
    assert profile_stages.idle_gaps(busy, ranges, (0.0, 80.0), n=1) == [(20.0, 50.0, "slic")]
    assert profile_stages.innermost(ranges, 47.0) == "accept"
    assert profile_stages.innermost(ranges, 80.0) is None
    # two ranges opened at once: the shorter is the inner one
    assert profile_stages.innermost([("outer", 0.0, 9.0), ("inner", 0.0, 4.0)], 1.0) == "inner"


def test_breakdown_without_device_events_is_not_measured():
    p = profile_stages.Profile(10.0, 0.0, {}, {"aten::add": 3}, [], [("lab", 0.0, 5.0)], [("aten::add", 1.0, 2.0)],
                               (0.0, 10.0))
    assert profile_stages.breakdown(p).startswith("not measured")


def test_breakdown_of_a_trace():
    p = profile_stages.Profile(
        wall_ms=0.1, device_ms=0.05, device_ops={"index_kernel": (0.04, 3), "add_kernel": (0.01, 2)},
        host_calls={}, busy=[(10.0, 30.0), (60.0, 90.0)], ranges=[("propagate", 0.0, 100.0)],
        ops=[("aten::item", 30.0, 58.0)], window=(0.0, 100.0),
    )
    b = profile_stages.breakdown(p)
    assert b["busy_share"] == 0.5
    assert [(o["name"], o["launches"]) for o in b["top_ops"]] == [("index_kernel", 3), ("add_kernel", 2)]
    assert b["idle_gaps"][0] == {"ms": 0.03, "at_ms": 0.03, "range": "propagate", "op": "aten::item"}


@pytest.mark.parametrize("argv", [
    ["2048", "2048", "array_width=7", "array_height=7", "min_disp=0", "max_disp=255", "inc=1",
     "--pair-layout", "view"],
    ["bl_ratio=1.5", "edge_enable=true", "spixl_size=16"],
])
def test_memcheck_overrides_follow_the_jax_rule(argv):
    """tools/memcheck.py: words with '=' are json.loads'd into
    SystemSettings.replace; the others are H and W (default 1080 1920)."""
    args = memcheck.parse(argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a and not a.startswith("--"))
    want = jax_config.SystemSettings().replace(**{k: json.loads(v) for k, v in kv.items()})
    assert SystemSettings().replace(**args.overrides).to_dict() == want.to_dict()
    pos = [a for a in argv if "=" not in a and not a.startswith("--") and a != "view"]
    assert (args.h, args.w) == ((int(pos[0]), int(pos[1])) if pos else (1080, 1920))
    assert args.pair_layout == ("view" if "--pair-layout" in argv else "packed")
