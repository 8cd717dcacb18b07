"""Multi-process runs of the port's ``parallel/`` on gloo, for the tests.

:func:`spawn` starts one process per rank, each running

    python torch_dist_worker.py JOB INIT_FILE WORLD RANK IN_NPZ OUT_PREFIX

and returns every rank's outputs.  A worker imports only torch, numpy and
the port (no JAX): it joins a gloo group through ``INIT_FILE`` (a
``file://`` rendezvous, no TCP port), reads its inputs from ``IN_NPZ``,
runs the job's cases and writes ``OUT_PREFIX<rank>.npz``.  ``kernels.build.load``
raises in a worker: CPU tensors never reach a kernel.  Each worker
uses one thread: several ranks share the host with pytest-xdist's workers.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def spawn(job: str, world: int, inputs: dict, tmp_dir, timeout: float = 300.0) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks; one dict of outputs per rank."""
    tmp_dir = str(tmp_dir)
    in_npz = os.path.join(tmp_dir, f"{job}_in.npz")
    np.savez(in_npz, **inputs)
    init = os.path.join(tmp_dir, f"{job}_{world}.init")
    prefix = os.path.join(tmp_dir, f"{job}_{world}_out")
    penv = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, init, str(world), str(r), in_npz, prefix],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=penv,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{job} rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}")
    outs = []
    for r in range(world):
        with np.load(f"{prefix}{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


# ---------------------------------------------------------------------------
# Jobs: each takes (inputs, rank, world) and returns a dict of arrays
# ---------------------------------------------------------------------------


def _settings(inputs):
    import json

    from cl_multiview_stereo_tpu_torch.config import SystemSettings

    return SystemSettings.from_dict(json.loads(str(inputs["settings"])))


def _mesh(name: str, n: int):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (n,), mesh_dim_names=(name,))


def job_spatial(inputs, rank, world) -> dict:
    """halo_exchange_rows, disp_sharded_depth_init, spatial_plane_sweep and
    spatial_refine on tests/test_spatial_sharding.py's scene."""
    import torch

    from cl_multiview_stereo_tpu_torch.config import RefinementSchedule
    from cl_multiview_stereo_tpu_torch.ops import refine
    from cl_multiview_stereo_tpu_torch.parallel import spatial

    out = {}
    tile, disp = _mesh("tile", world), _mesh("disp", world)
    x = torch.as_tensor(inputs["halo_x"])
    rows = x.shape[0] // world
    for halo in inputs["halos"].tolist():
        out[f"halo_{halo}"] = spatial.halo_exchange_rows(x[rank * rows:(rank + 1) * rows], halo, tile, "tile").numpy()

    s = _settings(inputs)
    lab, centers, step = (torch.as_tensor(inputs[k]) for k in ("lab", "center", "step"))
    for name in ("ladder", "ladder5"):
        out[f"depth_{name}"] = spatial.disp_sharded_depth_init(
            lab, centers, step, inputs[name], inputs["subset_num"], disp, s.array_width, s.bl_ratio,
        ).numpy()
    pairs = tuple((int(a), int(b), int(c), int(d)) for a, b, c, d in inputs["pairs"])
    for bl in inputs["sweep_bl"].tolist():
        d, c = spatial.spatial_plane_sweep(lab, inputs["ladder"], pairs, bl, tile)
        out[f"sweep_{bl}_disp"], out[f"sweep_{bl}_cost"] = d.numpy(), c.numpy()

    rs = s.replace(**{k: int(v) for k, v in zip(("kernel_size", "kernel_step", "no_prop"), inputs["refine_knobs"])})
    sched = RefinementSchedule.create(rs)
    ctx = refine.make_context(*(torch.as_tensor(inputs[k]) for k in
                                ("center", "color", "disp_init", "labels", "extent", "flatness")))
    rpairs = refine.pairs_from_subsets(inputs["view_subset"], s.array_width)
    for mode in ("none", "bound", "auto"):
        halo_disp = {"none": None, "bound": 2 * s.max_disp, "auto": "auto"}[mode]
        st = spatial.spatial_refine(ctx, sched, tile, pairs=rpairs, halo_disp=halo_disp)
        out.update({f"refine_{mode}_{f}": getattr(st, f).numpy() for f in st._fields})
    return out


def job_pipeline(inputs, rank, world) -> dict:
    """run_sharded on tests/test_sharded_pipeline.py's scene: each pipeline
    configuration over a ``make_mesh`` view axis, and over the view axis of
    a ``(host, view)`` mesh of hosts of two ranks and over both of its axes
    flattened (tests/multihost_worker.py's ``P(("host", "view"))``)."""
    from cl_multiview_stereo_tpu_torch.models.mvs_pipeline import MVSPipeline
    from cl_multiview_stereo_tpu_torch.parallel import make_host_view_mesh, make_mesh
    from cl_multiview_stereo_tpu_torch.parallel.mesh import axis_of
    from cl_multiview_stereo_tpu_torch.parallel.sharded_pipeline import run_sharded, sharded_pipeline_fn

    s = _settings(inputs)
    rgb = inputs["rgb"]
    h, w = rgb.shape[1:3]
    mesh = make_mesh(device_type="cpu")
    out = {}
    for name, kw in (("packed", {}), ("view", dict(pair_layout="view")),
                     ("cross_check", dict(cross_check=True)), ("gather", dict(depth_method="gather"))):
        pipe = MVSPipeline.create(w, h, s, device="cpu", **kw)
        out[name] = run_sharded(pipe, rgb, mesh).numpy()
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    hv = make_host_view_mesh(device_type="cpu")
    out["host_view_shape"] = np.asarray(hv.mesh.shape)
    out["host_view_ranks"] = hv.mesh.numpy()
    out["host_view"] = run_sharded(MVSPipeline.create(w, h, s, device="cpu"), rgb, hv).numpy()
    _, t, n = axis_of(hv, ("host", "view"))
    out["host_view_flat_index"] = np.asarray([t, n])
    flat = sharded_pipeline_fn(MVSPipeline.create(w, h, s, device="cpu"), hv, axis=("host", "view"))
    out["host_view_flat"] = flat(rgb).numpy()
    return out


def job_ba(inputs, rank, world) -> dict:
    """bundle_adjust_sharded on a BA problem's arrays."""
    import torch

    from cl_multiview_stereo_tpu_torch.models import sfm
    from cl_multiview_stereo_tpu_torch.parallel import make_mesh

    dtypes = dict(obs_cam=torch.int32, obs_pt=torch.int32)
    prob = sfm.BAProblem(*(torch.as_tensor(inputs[f]).to(dtypes.get(f, torch.float32))
                           for f in sfm.BAProblem._fields))
    out = sfm.bundle_adjust_sharded(prob, make_mesh(device_type="cpu"), iters=int(inputs["iters"]))
    return {f: getattr(out, f).numpy() for f in ("aa", "t", "X")}


def job_sfm(inputs, rank, world) -> dict:
    """run_sfm(mesh=...) on a camera-array batch."""
    from cl_multiview_stereo_tpu_torch.models.sfm_pipeline import run_sfm
    from cl_multiview_stereo_tpu_torch.parallel import make_mesh

    res = run_sfm(inputs["rgb"], _settings(inputs), device="cpu", mesh=make_mesh(device_type="cpu"),
                  k=int(inputs["k"]), max_matches=int(inputs["max_matches"]), ba_iters=int(inputs["ba_iters"]))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def main(job, init, world, rank, in_npz, prefix) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(_HERE))
    from cl_multiview_stereo_tpu_torch.parallel import initialize_distributed

    from cl_multiview_stereo_tpu_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"a CPU rank tried to build the {name} kernel")

    # every job runs on CPU tensors, which go to the plain forms: none may
    # reach a kernel's build (the consistency scorer above all)
    build.load = refuse
    world, rank = int(world), int(rank)
    initialize_distributed(f"file://{init}", world, rank, device="cpu")
    try:
        with np.load(in_npz) as z:
            inputs = {k: z[k] for k in z.files}
        out = globals()[f"job_{job}"](inputs, rank, world)
        np.savez(f"{prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
