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

  `rules`           the model stack's FSDP/TP specs as DTensor placements,
                    and the reference's constraint hooks as redistributes
                    (``make_production_mesh`` / ``make_debug_mesh`` build
                    the named meshes they lay out over).
  `local`           the ops DTensor does not propagate, run shard by shard.

Execution never enters result identity: fingerprints exclude the spec's
``devices`` field, so a sweep cached on one mesh is a hit on any other.
"""

from repro_torch.distributed.hogwild_shards import (run_hogwild_sharded,
                                                    sweep_hogwild_sharded)
from repro_torch.distributed.mesh import (SHARD_AXIS, DeviceMesh, MeshLike,
                                          from_devices, get_mesh,
                                          make_debug_mesh,
                                          make_production_mesh, resolve)
from repro_torch.distributed.partition import (element_plan,
                                               pad_to_multiple,
                                               run_grid_sharded)
from repro_torch.distributed.rules import (FSDP_AXES, act_constraint,
                                           batch_specs, data_axes,
                                           decode_act_constraint,
                                           decode_state_specs,
                                           head_constraint,
                                           inner_act_constraint,
                                           layer_constraint,
                                           logits_constraint,
                                           opt_state_specs, param_specs)

__all__ = [
    "SHARD_AXIS", "DeviceMesh", "MeshLike", "from_devices", "get_mesh",
    "resolve", "make_debug_mesh", "make_production_mesh",
    "element_plan", "pad_to_multiple", "run_grid_sharded",
    "run_hogwild_sharded", "sweep_hogwild_sharded",
    "FSDP_AXES", "act_constraint", "batch_specs", "data_axes",
    "decode_act_constraint", "decode_state_specs", "head_constraint",
    "inner_act_constraint", "layer_constraint", "logits_constraint",
    "opt_state_specs", "param_specs",
]
