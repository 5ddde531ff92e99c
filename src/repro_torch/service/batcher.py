"""Probe batching front end: N concurrent dataset-character probes -> one
masked-batch call (port of ``repro/service/batcher.py``).

Built on `serve.SlotDriver`.  The slot state is a fixed ``(n_slots,
max_rows, max_cols)`` envelope plus row and column validity masks, on the
batcher's device; each admitted probe writes its whole zero-padded
envelope into a free slot — the padding zeros overwrite whatever an
earlier probe left there, which the K1 count of
`core.advisor.masked_dataset_characters` needs — and one driver step
measures the whole slot batch.  Character probes finish in a single
step.

Probes larger than the envelope fall back to
`ScalabilityAdvisor.dataset_characters_batch` (the same computation over
the group's own envelope), counted in ``stats()["fallback"]``.  The
exact-dedup ``diversity`` is finished on the host per probe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import advisor as advisor_mod
from repro_torch.core import metrics as MX
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.serve.engine import SlotDriver

#: the (n_slots,)-shaped characters the masked computation produces; the
#: batcher turns each slot's slice into the scalar dict the
#: `analysis.fit` ``*_from_characters`` predictors consume
CHARACTER_KEYS = advisor_mod.DATASET_KEYS


class ProbeBatcher:
    """Coalesce dataset-character probes into slot-batched calls."""

    def __init__(self, n_slots: int = 8, max_rows: int = 512,
                 max_cols: int = 64, device=DEFAULT_DEVICE):
        self.n_slots = int(n_slots)
        self.max_rows = int(max_rows)
        self.max_cols = int(max_cols)
        self._advisor = advisor_mod.ScalabilityAdvisor(device=device)
        self.device = self._advisor.device
        self.n_batched = 0
        self.n_fallback = 0
        self.n_steps = 0

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)

        init_state = {
            "X": zeros(n_slots, max_rows, max_cols),
            "row_mask": zeros(n_slots, max_rows),
            "col_mask": zeros(n_slots, max_cols),
            "characters": {k: zeros(n_slots) for k in CHARACTER_KEYS},
        }

        def step_fn(state, active):
            ch = advisor_mod.masked_dataset_characters(
                state["X"], state["row_mask"], state["col_mask"])
            # character probes are single-step: every active slot is done
            return dict(state, characters=ch), torch.ones(
                self.n_slots, dtype=torch.bool, device=self.device)

        self.driver = SlotDriver(step_fn, init_state, n_slots)

    # -- helpers ------------------------------------------------------------
    def _payload(self, X: torch.Tensor) -> Dict:
        """The slot's whole envelope: X in the corner, zeros elsewhere."""
        r, c = X.shape
        Xp = torch.zeros((self.max_rows, self.max_cols), dtype=torch.float32,
                         device=self.device)
        Xp[:r, :c] = X
        rm = torch.zeros(self.max_rows, dtype=torch.float32,
                         device=self.device)
        rm[:r] = 1.0
        cm = torch.zeros(self.max_cols, dtype=torch.float32,
                         device=self.device)
        cm[:c] = 1.0
        return {"X": Xp, "row_mask": rm, "col_mask": cm}

    @staticmethod
    def _finish(ch: Dict, X: torch.Tensor) -> Dict:
        """Scalar-ize a slot's character slice and add the host-side
        exact-dedup diversity indices."""
        out = {k: (int(ch[k]) if k in ("n", "d") else float(ch[k]))
               for k in CHARACTER_KEYS}
        out["diversity"] = MX.diversity(X)
        out["diversity_ratio"] = out["diversity"] / max(out["n"], 1)
        return out

    # -- the batched measurement --------------------------------------------
    def measure(self, items: List[Tuple[object, object]]
                ) -> Dict[object, Optional[Dict]]:
        """Characters for every (request_id, X) item, batched through the
        slot driver; invalid datasets map to None (the caller pairs them
        with `ScalabilityAdvisor.invalid_report`).  Items beyond
        ``n_slots`` recycle freed slots across extra steps."""
        results: Dict[object, Optional[Dict]] = {}
        fallback: List[Tuple[object, torch.Tensor]] = []
        pending: List[Tuple[object, torch.Tensor]] = []
        for rid, X in items:
            reason = self._advisor.validate_dataset(X)
            if reason is not None:
                results[rid] = None
                continue
            X = advisor_mod.as_tensor(X, self.device)
            if X.shape[0] > self.max_rows or X.shape[1] > self.max_cols:
                fallback.append((rid, X))
            else:
                pending.append((rid, X))

        by_id = dict(pending)
        while pending or self.driver.n_active:
            while pending:
                rid, X = pending[0]
                if self.driver.admit(rid, self._payload(X)) is None:
                    break                     # slots full; step frees them
                pending.pop(0)
                self.n_batched += 1
            for rid, out in self.driver.step():
                results[rid] = self._finish(out["characters"], by_id[rid])
            self.n_steps += 1

        if fallback:
            # oversized probes: group-envelope masked batch
            self.n_fallback += len(fallback)
            chs = self._advisor.dataset_characters_batch(
                [X for _, X in fallback])
            for (rid, _), ch in zip(fallback, chs):
                results[rid] = ch
        return results

    def stats(self) -> Dict:
        return {"n_slots": self.n_slots,
                "envelope": [self.max_rows, self.max_cols],
                "batched": self.n_batched, "fallback": self.n_fallback,
                "steps": self.n_steps}
