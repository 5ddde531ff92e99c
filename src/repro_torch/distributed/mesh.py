"""The sweep mesh: an ordered list of devices the engine's batched
(m-grid x seed) elements are sharded over (port of
``repro/distributed/mesh.py``).

A :class:`DeviceMesh` is auto-detected (:func:`get_mesh`: every CUDA
device, or the one CPU), overridable to a prefix of that list
(``devices=4``), and degrades to a single-device fallback
(``n_devices == 1``) on which the engine takes its unsharded path bit
for bit.  :func:`from_devices` builds a mesh over any device list,
repeats included: ``from_devices([dev] * N)`` is N shards on one device,
run one after another, the port's counterpart of the reference's
``--xla_force_host_platform_device_count=N`` virtual devices.  The mesh
is an execution resource, never part of result identity: spec
fingerprints exclude it.

The model stack's named meshes (``make_production_mesh`` /
``make_debug_mesh``) belong with the FSDP/TP rules and are not part of
this module.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple, Union

import torch

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


def available(device=None) -> Tuple[torch.device, ...]:
    """The devices ``"auto"`` takes: every CUDA device, or the one CPU.
    ``device`` (a type or device) restricts the pool to its type."""
    kind = torch.device(device).type if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu")
    if kind == "cpu":
        return (torch.device("cpu"),)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def get_mesh(devices: MeshLike = None, *, device=None) -> DeviceMesh:
    """Resolve a sweep mesh from a ``--devices``-style request.

    ``None`` / ``"auto"`` take every available device (:func:`available`,
    of ``device``'s type when given); an int takes the first ``devices``
    of them, so 1 forces the fallback; a :class:`DeviceMesh` passes
    through.  Asking for more devices than exist clamps to what the host
    has, with a one-shot warning: results are mesh-invariant, so the
    request still runs."""
    global _CLAMP_WARNED
    if isinstance(devices, DeviceMesh):
        return devices
    avail = available(device)
    if not avail:
        raise ValueError("no CUDA device is available for the mesh")
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


def resolve(mesh: MeshLike, *, device=None) -> Optional[DeviceMesh]:
    """Engine-side resolution: ``None`` means "no distribution requested"
    (not "auto"), so every existing caller keeps the unsharded path."""
    if mesh is None:
        return None
    return get_mesh(mesh, device=device)
