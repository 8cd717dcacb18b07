"""Multi-device scaling on ``torch.distributed`` (port of
``cl_multiview_stereo_tpu/parallel``): a ``DeviceMesh`` with a ``view``
data-parallel axis and an optional ``disp`` axis, one rank per device;
the depth-slab and row-tile shardings of ``spatial``; the view-sharded
pipeline.  The collectives are explicit (``all_gather``, and
``all_reduce`` in ``models/sfm.bundle_adjust_sharded``), NCCL on the card
and gloo on the CPU.
"""

from cl_multiview_stereo_tpu_torch.parallel.distributed import (
    initialize_distributed,
    make_host_view_mesh,
)
from cl_multiview_stereo_tpu_torch.parallel.mesh import make_mesh, replicated, view_sharding
from cl_multiview_stereo_tpu_torch.parallel.spatial import (
    disp_sharded_depth_init,
    halo_exchange_rows,
    spatial_plane_sweep,
    spatial_refine,
)
