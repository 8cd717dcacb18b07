"""The port's propagate profile (``tools/profile_propagate``, the twin of
tools/profile_propagate.py and tools/profile_gathers.py) on the CPU at a
tiny scene (2x2 views of 48x64): every component of both engines and the
gather-rate ladder listed with null times; the timed total is the state
``refine.propagate_iteration`` returns on an independently built initial
state, bitwise, and so is the gather engine's plain-form sweep; the isolated accept chain is ``move_chain`` with the real
scorer, bitwise; each ladder gather is ``np.take`` on the same table and
rows; the ladder's byte bound is the sector count written out here."""

import json

import numpy as np
import pytest
import torch

from cl_multiview_stereo_tpu_torch.config import RefinementSchedule, SystemSettings, build_view_subsets
from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
from cl_multiview_stereo_tpu_torch.ops import refine
from cl_multiview_stereo_tpu_torch.tools import profile_propagate as pp
from cl_multiview_stereo_tpu_torch.tools import profile_stages, roofline
from torch_parity import CPU

SMALL = ["array_width=2", "array_height=2", "min_disp=4", "max_disp=11"]
H, W = 48, 64
S = SystemSettings(array_width=2, array_height=2, min_disp=4, max_disp=11)
COMPONENTS = {
    "gather": ["propagate_iteration[0]", "propagate_iteration[0], plain form", "rasterize_table", "build_cell_cache",
               "build_cell_cache, plain form", "consistency_moves (update)", "consistency_from_cache x1",
               "smoothness_moves (update)", "smoothness_from_cache x1", "update_candidates", "accept_chain",
               "init_state"],
    "strips": ["propagate_iteration[0]", "rasterize_table", "build_cell_cache", "build_cell_cache, plain form",
               "consistency_moves (update)", "smoothness_moves (update)", "smoothness_from_cache x1",
               "update_candidates", "accept_chain", "init_state"],
}
LADDER = ["(N,1) random int64", "(N,1) sorted int64", "(N,1) coherent int64", "(N,1) real int64",
          "(N,4) random int64", "(N,4) sorted int64", "(N,4) coherent int64", "(N,4) real int64",
          "(N,4) random int32 index_select", "(N,4) real int32 index_select", "(V*H,W,4) random 2-D int64",
          "(N,8) random int64", "(N,8) sorted int64", "(N,8) coherent int64", "(N,8) real int64"]


@pytest.fixture(scope="module")
def sw():
    return pp.setup(S, H, W, CPU)


@pytest.fixture(scope="module")
def record():
    return pp.main(["--device", "cpu", "--hw", f"{H}x{W}"] + [w for kv in SMALL for w in ("--set", kv)])


def test_cpu_record_lists_every_component_and_entry(record, capsys):
    assert record["engine"] == "both" and record["card"] == "cpu" and record["hw"] == f"{H}x{W}"
    assert record["settings"] == {"array_width": 2, "array_height": 2, "min_disp": 4, "max_disp": 11}
    for engine, names in COMPONENTS.items():
        comps = record["components"][engine]
        assert list(comps) == names
        for name, c in comps.items():
            assert c["ms"] is None and c["device_ms"] is None and c["launches"] is None and c["share"] is None, (
                engine, name)
        # the routed cache and smoothness make the sweep's calls (one cache,
        # the update and refit phases); their plain forms are measured beside
        assert comps["build_cell_cache"]["per_iteration"] == 1
        assert comps["smoothness_moves (update)"]["per_iteration"] == 2
        assert comps["build_cell_cache, plain form"]["per_iteration"] == 0
        assert comps["smoothness_from_cache x1"]["per_iteration"] == 0
        assert comps["init_state"]["per_iteration"] == 0
        assert record["parts_vs_total"][engine] == {"parts_ms": None, "total_ms": None, "parts_device_ms": None,
                                                    "total_device_ms": None, "parts_launches": None,
                                                    "total_launches": None}
    # the routed scorer makes the sweep's consistency calls; the plain form
    # is measured beside the sweep
    for engine in COMPONENTS:
        assert record["components"][engine]["consistency_moves (update)"]["per_iteration"] == 2
    gather = record["components"]["gather"]
    assert gather["consistency_from_cache x1"]["per_iteration"] == 0
    assert gather["propagate_iteration[0], plain form"]["per_iteration"] == 0
    assert list(record["ladder"]) == LADDER
    # one batch of 4 moves over 12 pairs, 6x8 cells, 9 samples
    rows = 4 * 12 * 6 * 9 * 8
    assert record["scene"] == {"views": 4, "map": [6, 8], "pairs": 12, "update_moves": 8, "score_chunk": 4,
                               "table_rows": 4 * H * W, "ladder_rows": rows}
    for name, e in record["ladder"].items():
        assert e["rows"] == rows and e["ms"] is None and e["m_rows_per_s"] is None and e["gb_per_s"] is None
        assert e["bound_ms"] == e["bytes"] / roofline.PEAK_BYTES_S * 1e3, name


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        pp.main(["--device", "cuda", "--hw", f"{H}x{W}"])


@pytest.mark.parametrize("engine", pp.ENGINES)
def test_total_is_propagate_iteration(sw, engine):
    """The tool's total against sweep 0 on an initial state built here from
    ``MVSPipeline.run``'s artifacts, not by the tool."""
    rgb = profile_stages.scene(S, H, W)
    art = MVSPipeline.create(W, H, S, device=CPU).run(rgb)
    sched = RefinementSchedule.create(S)
    ctx = refine.make_context(art.spmap.center, art.spmap.color, art.disp_init, art.labels, art.extent,
                              art.flatness)
    kw = dict(gamma=sched.gamma_eff, alpha=sched.alpha_eff, fuse=sched.fuse_eff, bl_ratio=sched.bl_ratio,
              pairs=refine.pairs_from_subsets(build_view_subsets(S)[0], S.array_width))
    state0 = refine.init_state(ctx, **kw, steps=sched.kernel_steps, step_size=sched.sp_kernel_step)
    want = refine.propagate_iteration(ctx, state0, 0, **kw, steps=sched.steps_per_iter[0],
                                      step_size=sched.step_size_per_iter[0], cons_engine=engine)
    got = pp.components(sw, engine)[pp.TOTAL].fn()
    for f in refine.RefineState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # and the tool's initial state is init_state's
    for f in refine.RefineState._fields:
        assert torch.equal(getattr(sw.state, f), getattr(state0, f)), f


def test_plain_sweep_is_the_gather_sweep_on_the_cpu(sw):
    """On the CPU the routed cache and scorers are their plain forms, so
    the plain-form sweep gives the routed sweep's bits, and so do the
    cache's two components."""
    comps = pp.components(sw, "gather")
    want = comps[pp.TOTAL].fn()
    got = comps["propagate_iteration[0], plain form"].fn()
    for f in refine.RefineState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    routed, plain = comps["build_cell_cache"].fn(), comps["build_cell_cache, plain form"].fn()
    for f in refine.IterCache._fields:
        a, b = getattr(routed, f), getattr(plain, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f


@pytest.mark.parametrize("engine", pp.ENGINES)
def test_accept_chain_replays_the_real_scores(sw, engine):
    def score(d_c, n_c):
        return refine.score_moves(sw.ctx, sw.cache, d_c, n_c, **sw.kw, cons_engine=engine)

    want = refine.move_chain(sw.cache, sw.state, sw.moves, 0, score)
    got = pp.components(sw, engine)["accept_chain"].fn()
    for f in refine.RefineState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # the chain accepted something, so the replay is not a no-op
    assert not torch.equal(got.n, sw.state.n)


def test_real_indices_are_the_gathered_rows(sw):
    """The recorded indices read the rows ``consistency_from_cache`` reads:
    a table whose rows hold their own index gives them back."""
    real = pp.real_indices(sw)
    assert real.dtype == torch.int64 and real.numel() == 4 * len(sw.kw["pairs"]) * 6 * 9 * 8
    assert 0 <= int(real.min()) and int(real.max()) < sw.cache.ras.shape[0]
    rec = pp.RecordIndex(torch.arange(sw.cache.ras.shape[0]))
    assert torch.equal(rec[real], real)


def test_ladder_gathers_equal_np_take_and_bytes_count_sectors(sw):
    names = []
    for e in pp.ladder(sw, pp.real_indices(sw)):
        names.append(e.name)
        out = e.fn()
        table = e.table.numpy().reshape(e.n_rows, -1)
        rows = e.rows.numpy()
        want = np.take(table, rows, axis=0).reshape(out.shape)
        np.testing.assert_array_equal(out.numpy(), want, err_msg=e.name)
        # rows of 4, 16 or 32 bytes: each row lies in one 32-byte sector
        sectors = np.unique(rows * e.row_bytes // 32).size
        n_bytes = 32 * sectors + sum(i.numel() * i.element_size() for i in e.indices) + out.numel() * 4
        assert roofline.gather_work(e.n_rows, e.row_bytes, e.rows, out, *e.indices) == (n_bytes, 0), e.name
    assert names == LADDER


def test_gather_work_by_hand():
    """Rows of 4 bytes: rows 0..7 share sector 0, 8..15 sector 1; rows of
    12 bytes: row 2 (bytes 24-35) spans sectors 0 and 1, row 5 (60-71)
    sectors 1 and 2."""
    rows = torch.tensor([0, 1, 7, 8, 9, 9])
    out = torch.zeros(6)
    assert roofline.gather_work(10, 4, rows, out, rows) == (2 * 32 + 6 * 8 + 6 * 4, 0)
    rows = torch.tensor([2, 5], dtype=torch.int32)
    out = torch.zeros(2, 3)
    assert roofline.gather_work(10, 12, rows.long(), out, rows) == (3 * 32 + 2 * 4 + 2 * 12, 0)
    rows = torch.tensor([0, 3, 3])
    out = torch.zeros(3, 8)
    n_bytes, n_ops = roofline.gather_work(4, 32, rows, out, rows)
    assert (n_bytes, n_ops) == (2 * 32 + 3 * 8 + 3 * 32, 0)
    assert roofline.bound(n_bytes, n_ops) == (184 / 3.35e12 * 1e3, "bytes")


def test_save_writes_each_engines_total_state(tmp_path, capsys):
    path = tmp_path / "state.npz"
    rec = pp.main(["--device", "cpu", "--hw", f"{H}x{W}", "--engine", "strips", "--save", str(path)]
                  + [w for kv in SMALL for w in ("--set", kv)])
    assert list(rec["components"]) == ["strips"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    with np.load(path) as z:
        assert sorted(z.files) == sorted(f"strips_{f}" for f in refine.RefineState._fields)
        assert z["strips_d"].shape == (4, 6, 8) and z["strips_n"].shape == (4, 6, 8, 3)


@pytest.mark.parametrize("kernels", [[3, 7], [0, 0, 7], [6, 6, 6]], ids=["second", "third", "never"])
def test_device_work_takes_a_trace_again_until_whole(monkeypatch, kernels):
    """A trace with fewer kernels than launch calls (torch.profiler's lost
    device events) is taken again; a whole one gives its device ms and
    kernels; none whole in PROFILE_TRIES raises."""
    from cl_multiview_stereo_tpu_torch.tools import profile_stages

    traces = iter(kernels)

    def fake(fn):
        fn()
        k = next(traces)
        return profile_stages.Profile(0.0, 0.5 * k, {"kern": (0.5 * k, k), "Memset (Device)": (0.1, 2)},
                                      {"cudaLaunchKernel": 7, "cudaMemsetAsync": 2}, [], [], [], None)

    monkeypatch.setattr(profile_stages, "profiled", fake)
    runs = []
    if kernels[-1] != 7:
        with pytest.raises(RuntimeError, match="no whole trace"):
            pp.device_work(lambda: runs.append(1))
    else:
        assert pp.device_work(lambda: runs.append(1)) == (3.5, 7)
    assert len(runs) == len(kernels) == min(len(kernels), pp.PROFILE_TRIES)
