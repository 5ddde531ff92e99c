"""The advisor service facade: request/response types and
`AdvisorService` (port of ``repro/service/api.py``).

  * :meth:`AdvisorService.probe` — one request, full path (admission ->
    batched character measurement -> tier routing -> response).  Safe to
    call from many threads at once; concurrent escalations sharing a spec
    fingerprint collapse into one sweep (`tiers.TierRouter`).
  * :meth:`AdvisorService.probe_batch` — N requests coalesced so their
    character measurements ride one masked-batch call
    (`batcher.ProbeBatcher`), then each routes through the tiers.

The service runs on its ``device`` — the GPU unless the caller asks for
the CPU; it raises without a GPU.  Every response is a `ProbeResponse`;
nothing raises for bad probes — invalid inputs come back
``status="invalid"`` with the advisor's structured report, and admission
overflow comes back ``status="overloaded"``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.experiments import runner as runner_mod
from repro_torch.experiments import spec as spec_mod
from repro_torch.experiments.spec import DatasetSpec, SweepSpec
from repro_torch.service.batcher import ProbeBatcher
from repro_torch.service.queue import AdmissionQueue
from repro_torch.service.tiers import (DEFAULT_CONFIDENCE_THRESHOLD,
                                       TierRouter)
from repro_torch.telemetry import metrics, trace

_REQUEST_IDS = itertools.count()

#: per-tier routing latency (seconds), labeled by the tier that answered:
#: "analytic" is sub-ms formula evaluation, "measured" includes the
#: escalated sweep (or its cache/dedup hit) — the split IS the service's
#: latency story
_TIER_LATENCY = {
    t: metrics.histogram("repro_service_tier_latency_seconds",
                         help="probe routing latency by answering tier",
                         labels={"tier": t})
    for t in ("analytic", "measured", "invalid")
}

#: distribution of analytic confidences at routing time — mass below the
#: escalation threshold is the fraction of traffic buying measurements
_CONFIDENCE = metrics.histogram(
    "repro_service_confidence",
    help="analytic confidence observed per routed probe",
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))


@dataclasses.dataclass
class ProbeRequest:
    """One scalability probe.

    Exactly one of ``X`` (raw dataset), ``grads`` (per-shard gradient
    pytrees), ``dataset`` (a reproducible `DatasetSpec`), or ``sweep``
    (a full `SweepSpec` — its first dataset is probed) should be set.
    Only the spec-carrying shapes can escalate to a measured sweep: raw
    arrays have no fingerprintable identity (see docs/service.md).

    ``escalate``: None = confidence-gated (the default), True = force
    the measured tier, False = never escalate.
    """
    X: Optional[Any] = None
    grads: Optional[List] = None
    dataset: Optional[DatasetSpec] = None
    sweep: Optional[SweepSpec] = None
    algorithm: str = "hogwild"
    escalate: Optional[bool] = None
    kwargs: Dict = dataclasses.field(default_factory=dict)
    request_id: str = dataclasses.field(
        default_factory=lambda: f"probe-{next(_REQUEST_IDS)}")

    @property
    def kind(self) -> str:
        return "grads" if self.grads is not None else "dataset"

    def materialize_X(self, rows_cap: int, device):
        """The dataset the analytic tier measures: the raw ``X`` as given,
        or the (deterministically generated) spec dataset on ``device``,
        row-capped like the runner's characters report."""
        if self.X is not None:
            return self.X
        ds = self.dataset
        if ds is None and self.sweep is not None and self.sweep.datasets:
            ds = next(iter(self.sweep.datasets.values()))
        if ds is None:
            return None
        X = spec_mod.build_dataset(ds, device).X
        return X[:rows_cap] if rows_cap else X


@dataclasses.dataclass
class ProbeResponse:
    """status: "ok" | "invalid" | "overloaded"; tier: "analytic" |
    "measured" | None (shed/invalid requests never reach a tier)."""
    request_id: str
    status: str
    tier: Optional[str]
    confidence: float
    confidence_detail: Dict
    report: Dict
    escalation: Optional[Dict] = None
    note: Optional[str] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class AdvisorService:
    """Batching + tiering + admission in front of `ScalabilityAdvisor`."""

    def __init__(self, *, n_slots: int = 8, max_rows: int = 512,
                 max_cols: int = 64, queue_depth: int = 32,
                 confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
                 cache_dir: Optional[str] = None,
                 cache_cap: Optional[int] = None,
                 parallel_cost: float = 1e-3,
                 sweep_ms=(1, 2, 4), sweep_iters: int = 200,
                 sweep_eval_every: int = 20,
                 characters_rows: int = runner_mod.DEFAULT_CHARACTERS_ROWS,
                 device=DEFAULT_DEVICE):
        self.queue = AdmissionQueue(queue_depth)
        self.batcher = ProbeBatcher(n_slots=n_slots, max_rows=max_rows,
                                    max_cols=max_cols, device=device)
        self.device = self.batcher.device
        self.tiers = TierRouter(
            confidence_threshold=confidence_threshold, cache_dir=cache_dir,
            cache_cap=cache_cap, parallel_cost=parallel_cost,
            sweep_ms=sweep_ms, sweep_iters=sweep_iters,
            sweep_eval_every=sweep_eval_every, device=self.device)
        self.characters_rows = int(characters_rows)
        self._batch_lock = threading.Lock()

    # -- the front door -----------------------------------------------------
    def probe(self, request: ProbeRequest) -> ProbeResponse:
        return self.probe_batch([request])[0]

    def probe_batch(self, requests: List[ProbeRequest]
                    ) -> List[ProbeResponse]:
        responses: Dict[str, ProbeResponse] = {}
        admitted: List[ProbeRequest] = []
        stamps: List[float] = []
        for r in requests:
            stamp = self.queue.try_admit()
            if stamp is not None:
                admitted.append(r)
                stamps.append(stamp)
            else:
                responses[r.request_id] = ProbeResponse(
                    request_id=r.request_id, status="overloaded",
                    tier=None, confidence=0.0, confidence_detail={},
                    report={}, note=f"admission queue full (depth "
                                    f"{self.queue.depth}); shed — retry "
                                    f"after in-flight probes drain")
        try:
            with trace.span("measure_batch", n=len(admitted)):
                characters = self._measure(admitted)
            for r in admitted:
                t0 = time.perf_counter()
                with trace.span("respond", request_id=r.request_id):
                    resp = self._respond(r, characters.get(r.request_id))
                tier = resp.tier if resp.tier is not None else "invalid"
                _TIER_LATENCY[tier].observe(time.perf_counter() - t0)
                if resp.tier is not None:
                    # the analytic confidence that routed the probe — for
                    # measured answers that's the pre-escalation one
                    conf = resp.confidence_detail
                    if resp.tier == "measured":
                        conf = conf.get("analytic", {})
                    _CONFIDENCE.observe(float(conf.get("confidence", 0.0)))
                responses[r.request_id] = resp
        finally:
            for stamp in stamps:
                self.queue.release(admitted_at=stamp)
        return [responses[r.request_id] for r in requests]

    # -- stage 1: batched character measurement -----------------------------
    def _measure(self, requests: List[ProbeRequest]
                 ) -> Dict[str, Optional[Dict]]:
        """One masked-batch call for the dataset probes (slot driver) and
        one for the gradient probes; the lock serializes driver state,
        NOT escalation — concurrent `probe()` callers still overlap in
        the measured tier, which is what the dedup table collapses."""
        ds_items, grad_items = [], []
        with trace.span("materialize", n=len(requests)):
            for r in requests:
                if r.kind == "grads":
                    grad_items.append(r)
                else:
                    ds_items.append(
                        (r.request_id,
                         r.materialize_X(self.characters_rows, self.device)))
        out: Dict[str, Optional[Dict]] = {}
        with self._batch_lock:
            if ds_items:
                out.update(self.batcher.measure(ds_items))
            if grad_items:
                chs = self.batcher._advisor.grad_characters_batch(
                    [r.grads for r in grad_items],
                    n_slots=self.batcher.n_slots)
                out.update({r.request_id: ch
                            for r, ch in zip(grad_items, chs)})
        return out

    # -- stage 2: per-request tier routing ----------------------------------
    def _respond(self, request: ProbeRequest,
                 ch: Optional[Dict]) -> ProbeResponse:
        adv = self.batcher._advisor
        if ch is None:
            if request.kind == "grads":
                reason = adv.validate_grads(request.grads) or \
                    "unmeasurable gradient probe"
            else:
                X = request.materialize_X(self.characters_rows,
                                          self.device)
                reason = adv.validate_dataset(X) or "unmeasurable dataset"
            return ProbeResponse(
                request_id=request.request_id, status="invalid", tier=None,
                confidence=0.0, confidence_detail={},
                report=adv.invalid_report(request.kind, reason))

        conf = self.tiers.confidence(
            ch, "dataset" if request.kind == "dataset" else "grads")
        if request.kind == "grads":
            report = self.tiers.analytic_grad_report(ch)
        else:
            report = self.tiers.analytic_dataset_report(ch, request.kwargs)

        wants_sweep = (request.escalate is True or
                       (request.escalate is None and
                        conf["confidence"] < self.tiers.threshold))
        if not wants_sweep:
            return ProbeResponse(
                request_id=request.request_id, status="ok", tier="analytic",
                confidence=float(conf["confidence"]),
                confidence_detail=conf, report=report)

        if self.tiers.escalation_spec(request) is None:
            return ProbeResponse(
                request_id=request.request_id, status="ok", tier="analytic",
                confidence=float(conf["confidence"]),
                confidence_detail=conf, report=report,
                note="escalation unavailable: raw in-memory probes carry "
                     "no reproducible dataset identity — pass a "
                     "DatasetSpec or SweepSpec to enable the measured "
                     "tier")
        esc = self.tiers.escalate(request)
        return ProbeResponse(
            request_id=request.request_id, status="ok", tier="measured",
            confidence=1.0 if esc["healthy"] else 0.0,
            confidence_detail={"source": "measured",
                               "analytic": conf,
                               "job_status": esc["status"]},
            report=report, escalation=esc)

    def stats(self) -> Dict:
        return {"queue": self.queue.stats(),
                "batcher": self.batcher.stats(),
                "tiers": self.tiers.stats(),
                "sweep_computes": runner_mod.SWEEP_COMPUTES,
                # registry-backed observability block: service counters,
                # gauges, latency and confidence histograms
                "telemetry": metrics.REGISTRY.to_dict(
                    prefix="repro_service")}
