"""The sweep mesh: an ordered list of devices the engine's batched
(m-grid x seed) elements are sharded over (port of
``repro/distributed/mesh.py``).

A :class:`DeviceMesh` is auto-detected (:func:`get_mesh`: every CUDA
device, or the one CPU when the caller names it), overridable to a
prefix of that list (``devices=4``), and degrades to a single-device
fallback (``n_devices == 1``) on which the engine takes its unsharded
path bit for bit.  :func:`from_devices` builds a mesh over any device list,
repeats included: ``from_devices([dev] * N)`` is N shards on one device,
run one after another, the port's counterpart of the reference's
``--xla_force_host_platform_device_count=N`` virtual devices.  The mesh
is an execution resource, never part of result identity: spec
fingerprints exclude it.

**Model-stack meshes** (:func:`make_production_mesh`,
:func:`make_debug_mesh`): the named ('pod', 'data', 'model') torch
``DeviceMesh``es that `repro_torch.distributed.rules` lays FSDP/TP
placements over, built over the process group in force (a real NCCL or
gloo group, or a fake one for the dry run).  They are functions: importing
this module starts no process group.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

#: the sweep mesh's single axis name (the batched grid-element axis)
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the engine's grid-element axis: shard k runs on
    ``devices[k]``.  ``n_devices == 1`` is the fallback signal: the engine
    bypasses the partitioner and runs its unsharded path."""

    devices: Tuple[torch.device, ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """One-line report (printed at CLI startup)."""
        kinds = sorted({d.type for d in self.devices})
        ids = ", ".join(str(d) for d in self.devices[:8])
        if self.n_devices > 8:
            ids += ", ..."
        mode = ("single-device fallback (unsharded engine path)"
                if self.n_devices == 1 else
                f"sharding grid elements over axis {SHARD_AXIS!r}")
        return (f"mesh: {self.n_devices} x {'/'.join(kinds)} device"
                f"{'s' if self.n_devices != 1 else ''} [{ids}] — {mode}")


MeshLike = Union[None, str, int, DeviceMesh]

#: one-shot flag for the over-subscription warning (tests reset it)
_CLAMP_WARNED = False


def available(device=DEFAULT_DEVICE) -> Tuple[torch.device, ...]:
    """The devices ``"auto"`` takes: every CUDA device, or the one CPU
    when ``device`` (a type or device) names it.  Raises as
    :func:`~repro_torch.device.resolve_device` does for CUDA on a host
    without it."""
    kind = resolve_device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def get_mesh(devices: MeshLike = None, *,
             device=DEFAULT_DEVICE) -> DeviceMesh:
    """Resolve a sweep mesh from a ``--devices``-style request.

    ``None`` / ``"auto"`` take every available device of ``device``'s
    type (:func:`available`); an int takes the first ``devices``
    of them, so 1 forces the fallback; a :class:`DeviceMesh` passes
    through.  Asking for more devices than exist clamps to what the host
    has, with a one-shot warning: results are mesh-invariant, so the
    request still runs."""
    global _CLAMP_WARNED
    if isinstance(devices, DeviceMesh):
        return devices
    avail = available(device)
    if devices is None or devices == "auto":
        n = len(avail)
    else:
        n = int(devices)
        if n < 1:
            raise ValueError(f"devices={devices!r} must be >= 1")
        if n > len(avail):
            if not _CLAMP_WARNED:
                warnings.warn(
                    f"devices={n} requested but only {len(avail)} "
                    f"{avail[0].type} device"
                    f"{'s' if len(avail) != 1 else ''} available — "
                    f"clamping to {len(avail)} (results are "
                    f"mesh-invariant; from_devices([dev] * {n}) runs "
                    f"{n} shards on one device)", RuntimeWarning,
                    stacklevel=2)
                _CLAMP_WARNED = True
            n = len(avail)
    return from_devices(avail[:n])


def from_devices(devs: Sequence) -> DeviceMesh:
    """The 1-D sweep mesh over an explicit device list (repeats allowed:
    several shards on one device run one after another)."""
    devs = tuple(torch.device(d) for d in devs)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DeviceMesh(devs)


def resolve(mesh: MeshLike, *,
            device=DEFAULT_DEVICE) -> Optional[DeviceMesh]:
    """Engine-side resolution: ``None`` means "no distribution requested"
    (not "auto"), so every existing caller keeps the unsharded path."""
    if mesh is None:
        return None
    return get_mesh(mesh, device=device)


# ---------------------------------------------------------------------------
# Model-stack meshes
# ---------------------------------------------------------------------------

#: the production mesh's (data, model) shape: 256 H100s as 32 nodes of 8,
#: 'model' inside one node's NVLink domain (the reference's TPU pod is 16x16)
PRODUCTION_SHAPE = (32, 8)


def _named_mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh as _init
    return _init(resolve_device(device_type).type, tuple(shape),
                 mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type=DEFAULT_DEVICE):
    """256 ranks as (data 32, model 8), or 512 as (pod 2, data 32, model 8)
    with ``multi_pod``, over the process group in force (its world size
    must match), on the card unless ``device_type`` names the CPU.

    The reference's production mesh is a TPU pod's 16 x 16 torus, whose
    links are alike along both axes.  An H100 machine has two tiers: 8
    GPUs of one node joined all to all by NVLink, and nodes joined by the
    network at about a ninth of that rate.  Tensor parallelism ('model')
    sends activations every layer, FSDP ('data') sends weights once a
    layer, so 'model' gets the fast tier: 8 wide, one node, and 'data'
    spans the 32 nodes."""
    data, model = PRODUCTION_SHAPE
    if multi_pod:
        return _named_mesh((2, data, model), ("pod", "data", "model"),
                           device_type)
    return _named_mesh((data, model), ("data", "model"), device_type)


def make_debug_mesh(data=2, model=2, pod=0, *, device_type=DEFAULT_DEVICE):
    """A small (data, model) mesh, or (pod, data, model) when ``pod``,
    over the process group in force, on the card unless ``device_type``
    names the CPU."""
    if pod:
        return _named_mesh((pod, data, model), ("pod", "data", "model"),
                           device_type)
    return _named_mesh((data, model), ("data", "model"), device_type)


def is_model_mesh(mesh) -> bool:
    """True for a named torch ``DeviceMesh`` (a model-stack mesh)."""
    from torch.distributed.device_mesh import DeviceMesh as _TorchMesh
    return isinstance(mesh, _TorchMesh) and mesh.mesh_dim_names is not None


def check_model_mesh(mesh):
    """``mesh`` itself when it is None or a named torch ``DeviceMesh``;
    raises TypeError for anything else."""
    if mesh is not None and not is_model_mesh(mesh):
        raise TypeError(f"mesh must be a named torch DeviceMesh "
                        f"(make_debug_mesh / make_production_mesh) or "
                        f"None, not {type(mesh).__name__}")
    return mesh
