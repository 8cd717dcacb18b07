"""The harness on the CPU at a tiny size: data files parse, a cell made of
new data files runs, the result line keeps to the contract, the names keep
to their characters, and a run with the timed path broken comes out not
correct."""

from __future__ import annotations

import json
import re
import time
from pathlib import Path

import pytest
import torch

from mvs_bench import harness, judge, run
from mvs_bench.tests.conftest import BENCH, REPO, TINY, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_data_file_parses_and_every_metric_has_a_reader():
    from cl_multiview_stereo_tpu_torch.config import SystemSettings

    spec = _spec()
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        SystemSettings.from_dict(cfg["settings"])
        assert set(c["reduced"]) == set(cfg["reduced"])
    for path in sorted((BENCH / "traffic").glob("*.json")) + sorted((BENCH / "limits").glob("*.json")):
        json.loads(path.read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(REPO / "BENCHMARK.json", BENCH, w["name"])
        assert set(cell.limits) == set(judge.NUMBERS)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness._reader(m["name"], [BENCH]))


def test_names_units_and_paths_use_only_allowed_characters():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [r for c in spec["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in spec["end_to_end"] + spec["per_layer"])
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
    for f in BENCH.rglob("*"):
        if "__pycache__" not in f.parts and f.is_file():
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(f.relative_to(REPO))), f
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in spec["per_layer"])


def _run_tiny(tmp_path: Path, seconds: float = 0.5) -> dict:
    root = tiny_root(tmp_path)
    cell = harness.load_cell(root / "BENCHMARK.json", root, TINY)
    return harness.run_cell(cell, seed=2**31 + 7, seconds=seconds, trace=False, dev=torch.device("cpu"),
                            root=root, t_start=time.perf_counter())


def test_a_cell_of_new_data_files_runs_and_its_line_keeps_to_the_contract(tmp_path):
    res = _run_tiny(tmp_path)
    assert list(res) == RESULT_KEYS  # ``checks`` last
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"depth_mp_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    json.dumps(res)


def _patched(monkeypatch, module: str, name: str, fn):
    import importlib

    monkeypatch.setattr(importlib.import_module(module), name, fn)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_views_left_out", "answer_altered"])
def test_a_broken_timed_path_comes_out_not_correct(tmp_path, monkeypatch, fault):
    from cl_multiview_stereo_tpu_torch.ops import fusion

    fuse = fusion.fuse_views
    if fault == "state_unchanged":  # every sweep hands its input state on
        _patched(monkeypatch, "cl_multiview_stereo_tpu_torch.ops.refine", "propagate_iteration",
                 lambda ctx, state_in, it, **kw: state_in)
    elif fault == "half_the_views_left_out":
        def half(*a, **kw):
            out = fuse(*a, **kw).clone()
            out[out.shape[0] // 2:] = 0.0
            return out
        _patched(monkeypatch, "cl_multiview_stereo_tpu_torch.ops.fusion", "fuse_views", half)
    else:  # one view's map a pixel off where fusion produces it
        def altered(*a, **kw):
            out = fuse(*a, **kw).clone()
            out[0] += 1.0
            return out
        _patched(monkeypatch, "cl_multiview_stereo_tpu_torch.ops.fusion", "fuse_views", altered)
    res = _run_tiny(tmp_path)
    assert res["correct"] is False and res["failed"] >= 1


def test_without_a_card_the_run_prints_no_result_and_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "rig3x3.offline", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("loaded", [None, "jax", "jaxlib.xla_client", "flax", "cl_multiview_stereo_tpu.ops"])
def test_a_forbidden_module_loaded_by_the_run_withholds_the_result(monkeypatch, capsys, loaded):
    """Whatever a run loads up to the result line counts: here a run that
    loads the module only at its end, as a metric's reader could."""
    import sys
    import types

    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)

    def fake_run(cell, **kw):
        if loaded:
            monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}, "checks": {}}

    monkeypatch.setattr(harness, "run_cell", fake_run)
    rc = run.main(["--workload", "rig3x3.offline", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if loaded is None:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"] is True
    else:
        assert rc != 0 and out == "" and loaded in err


def test_the_reservoir_repeats_from_its_seed_and_covers_the_window():
    picks = lambda seed: [harness.Reservoir(3, seed).pick(i) for i in range(200)]  # noqa: E731
    assert picks(2**40 + 3) == picks(2**40 + 3)
    last = {}
    for seed in range(200):
        r = harness.Reservoir(3, seed)
        kept = {}
        for i in range(60):
            s = r.pick(i)
            if s is not None:
                kept[s] = i
        for i in kept.values():
            last[i // 20] = last.get(i // 20, 0) + 1
    assert all(last.get(b, 0) > 100 for b in range(3))  # early, middle and late scenes are all sampled


def _fake_loop(check: int = 0):
    from types import SimpleNamespace

    pool = [torch.zeros((2, 4, 6, 3), dtype=torch.uint8) for _ in range(3)]
    calls = []

    def forward(cap):
        calls.append(len(calls))
        return SimpleNamespace(disp_full=torch.full((2, 4, 6), float(len(calls))))

    return harness.Loop(forward, pool, check, 5, torch.device("cpu")), calls


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_the_closed_loop_keeps_its_scenes_in_flight_and_finishes_each(in_flight):
    loop, calls = _fake_loop(check=2)
    recs = loop.closed(None, 7, in_flight=in_flight)
    assert len(recs) == len(calls) == 7 == loop.count
    assert all(due == start <= done for due, start, done in recs)
    assert [r[1] for r in recs] == sorted(r[1] for r in recs)
    assert all(k is not None for k in loop.kept)


def test_the_open_loop_waits_on_a_clock_that_moves_between_reads(monkeypatch):
    """Every read of the clock is 1.5 ms later than the last: the wait for a
    due time never sleeps for a negative length."""
    import itertools

    ticks = itertools.count()
    monkeypatch.setattr(harness, "now", lambda: 0.0015 * next(ticks))

    def sleep(s):
        if s < 0:
            raise ValueError("sleep length must be non-negative")

    monkeypatch.setattr(harness.time, "sleep", sleep)
    loop, calls = _fake_loop()
    recs, late = loop.open(10.0, None, 6, sample=False)
    assert len(recs) == len(calls) == 6
    assert all(due <= start <= done for due, start, done in recs)
