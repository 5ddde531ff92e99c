"""Shard the engine's batched (m-grid x seed) simulations over a mesh
(port of ``repro/distributed/partition.py``).

Each bucket of the worker grid is a batch of independent ``(grid member
m, seed replicate s)`` elements, so the batch can be split across the
mesh's shards and every element still computes what it computes in one
batch: results are mesh-invariant (1e-5; ECD-PSGD, whose quantizer turns
an ulp into a quantum, to its 2e-2 envelope).  :func:`run_grid_sharded`
is the sharded twin of the engine's group loop; for every bucket it

  1. flattens the bucket's (members x seeds) cells into one element axis,
     so the seed axis shards too,
  2. pads that axis to a multiple of the shard count by repeating
     element 0 (the padding rows are dropped after),
  3. hands shard k its contiguous slice of ``(m, s)`` indices and runs it
     on ``mesh.devices[k]``, shards one after another,
  4. gathers onto the first shard's device, drops the padding and
     scatters the rows back to grid order.

The engine owns the bucket policy and the simulation; both arrive as
arguments, which keeps this module free of engine imports.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.mesh import DeviceMesh
from repro_torch.telemetry import instrument, trace


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n``."""
    return -(-n // k) * k


def element_plan(pos: Sequence[int], ms: Sequence[int], n_seeds: int,
                 n_devices: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flattened, padded (m, seed) index arrays for one bucket.

    Element ``e`` is grid member ``pos[e // n_seeds]`` under seed
    ``e % n_seeds``; padding repeats element 0.  Returns ``(m_idx, s_idx,
    n_real)`` with ``len(m_idx) % n_devices == 0``."""
    m_idx = [ms[i] for i in pos for _ in range(n_seeds)]
    s_idx = [s for _ in pos for s in range(n_seeds)]
    n_real = len(m_idx)
    n_pad = pad_to_multiple(n_real, n_devices) - n_real
    m_idx += m_idx[:1] * n_pad
    s_idx += s_idx[:1] * n_pad
    return (np.asarray(m_idx, np.int32), np.asarray(s_idx, np.int32),
            n_real)


def run_grid_sharded(run_elements: Callable, ms: Sequence[int],
                     n_seeds: int, dmesh: DeviceMesh,
                     buckets: List[Tuple[Tuple[int, ...], int]]
                     ) -> torch.Tensor:
    """Run the whole grid sharded over ``dmesh``; rows follow ``ms``.

    ``run_elements(m_list, s_list, m_pad, device)`` runs the elements
    ``(m_list[b], s_list[b])`` as one batch at pad width ``m_pad`` on
    ``device`` and returns their ``(len(m_list), n_evals)`` losses; it
    must obey the engine's masked-simulation contract (an element's
    numerics do not depend on ``m_pad`` or on the other elements).
    ``buckets`` is the engine's ``[(positions, m_pad), ...]`` partition.
    Returns ``(S, n_seeds, n_evals)`` on the first shard's device."""
    D = dmesh.n_devices
    home = dmesh.devices[0]
    rows: List = [None] * len(ms)
    for pos, m_pad in buckets:
        m_idx, s_idx, n_real = element_plan(pos, ms, n_seeds, D)
        per = len(m_idx) // D
        with trace.span("shard_put", devices=D, elements=len(m_idx)):
            shards = [(m_idx[k * per:(k + 1) * per].tolist(),
                       s_idx[k * per:(k + 1) * per].tolist(), dev)
                      for k, dev in enumerate(dmesh.devices)]

        def run_shards(shards=shards, m_pad=m_pad):
            return [run_elements(m_list, s_list, m_pad, dev)
                    for m_list, s_list, dev in shards]

        outs = instrument.dispatch(
            run_shards, span_name="mesh_bucket", devices=D,
            elements=len(m_idx), m_pad=m_pad)
        with trace.span("gather", elements=n_real):
            out = torch.cat([o.to(home) for o in outs])[:n_real]
        out = out.reshape(len(pos), n_seeds, -1)
        for k, i in enumerate(pos):
            rows[i] = out[k]
    return torch.stack(rows)
