"""repro_torch.distributed — device-mesh execution for sweeps (port of
``repro/distributed``).

  `mesh`            :class:`DeviceMesh`, an ordered list of devices:
                    auto-detected (:func:`get_mesh`: every CUDA device,
                    or the one CPU), overridable (``--devices N``), or
                    explicit (:func:`from_devices`, repeats allowed: N
                    shards on one device run one after another); one
                    device is the fallback, bit-exact with the unsharded
                    engine path.
  `partition`       the grid partitioner: each bucket's (members x
                    seeds) elements flattened, padded and split over the
                    shards.
  `hogwild_shards`  racing Hogwild!: worker shards racing on local copies
                    and reconciling by a sum of deltas; the engine's
                    staleness recurrence stays the parity oracle.

Execution never enters result identity: fingerprints exclude the spec's
``devices`` field, so a sweep cached on one mesh is a hit on any other.
The model stack's FSDP/TP rules and named meshes are not ported here.
"""

from repro_torch.distributed.hogwild_shards import (run_hogwild_sharded,
                                                    sweep_hogwild_sharded)
from repro_torch.distributed.mesh import (SHARD_AXIS, DeviceMesh, MeshLike,
                                          from_devices, get_mesh, resolve)
from repro_torch.distributed.partition import (element_plan,
                                               pad_to_multiple,
                                               run_grid_sharded)

__all__ = [
    "SHARD_AXIS", "DeviceMesh", "MeshLike", "from_devices", "get_mesh",
    "resolve", "element_plan", "pad_to_multiple", "run_grid_sharded",
    "run_hogwild_sharded", "sweep_hogwild_sharded",
]
