"""Tiered escalation: analytic early exit, measured sweep on low
confidence (port of ``repro/service/tiers.py``).

Tier 1 is *analytic*: the `analysis.fit` ``*_from_characters``
predictors answer a probe at once from its measured characters, at a
confidence derived from the characters->m_max regression over the sweeps
already in the port's artifact cache (`fit.analytic_confidence`;
`fit.CONFIDENCE_PRIOR` with no history).  Probes whose confidence clears
the threshold exit there, with no sweep.  Below it (or when the caller
forces it), tier 2 runs a *measured* sweep through
`experiments.runner.run_sweep(dedup=True)` on the router's device:
concurrent escalations sharing a fingerprint execute one sweep and every
waiter is answered from the stored artifact.  Escalations inherit the
runner's crash journal and retries.

Only probes with a reproducible dataset identity (a `DatasetSpec` or a
`SweepSpec`) can escalate; a raw array's low-confidence analytic answer
comes back with an ``escalation unavailable`` note instead.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from repro_torch.analysis import fit as FIT
from repro_torch.core import advisor as advisor_mod
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.experiments import cache as artifact_cache
from repro_torch.experiments import runner as runner_mod
from repro_torch.experiments import spec as spec_mod
from repro_torch.experiments.spec import EpsilonSpec, JobSpec, SweepSpec
from repro_torch.telemetry import metrics, trace

_ANALYTIC = metrics.counter("repro_service_analytic_answers_total",
                            help="probes answered by the analytic tier")
_ESCALATIONS = metrics.counter("repro_service_escalations_total",
                               help="probes escalated to a measured sweep")

#: default analytic-tier confidence gate — sits below
#: `fit.CONFIDENCE_PRIOR` (0.75) on purpose: a fresh service with no
#: measured history trusts the theory predictors; history that fits
#: poorly (low R^2 / big residuals) pulls confidence under the gate and
#: starts buying measurements
DEFAULT_CONFIDENCE_THRESHOLD = 0.5

#: default escalation sweep shape: the smallest grid that yields an
#: epsilon readout (probe_m=2 must be on the grid) and a measured m_max
DEFAULT_SWEEP_MS = (1, 2, 4)
DEFAULT_SWEEP_ITERS = 200
DEFAULT_SWEEP_EVAL_EVERY = 20


class TierRouter:
    """Confidence-gated routing between the analytic and measured tiers."""

    def __init__(self, *, confidence_threshold: float =
                 DEFAULT_CONFIDENCE_THRESHOLD,
                 cache_dir: Optional[str] = None,
                 cache_cap: Optional[int] = None,
                 parallel_cost: float = 1e-3,
                 sweep_ms=DEFAULT_SWEEP_MS,
                 sweep_iters: int = DEFAULT_SWEEP_ITERS,
                 sweep_eval_every: int = DEFAULT_SWEEP_EVAL_EVERY,
                 device=DEFAULT_DEVICE):
        self.threshold = float(confidence_threshold)
        self.cache_dir = cache_dir or artifact_cache.DEFAULT_CACHE_DIR
        self.cache_cap = cache_cap
        self.parallel_cost = parallel_cost
        self.sweep_ms = tuple(sweep_ms)
        self.sweep_iters = int(sweep_iters)
        self.sweep_eval_every = int(sweep_eval_every)
        self.advisor = advisor_mod.ScalabilityAdvisor(
            parallel_cost=parallel_cost, device=device)
        self.device = self.advisor.device
        self._lock = threading.Lock()
        self._model: Optional[Dict] = None
        self._model_stale = True
        self.analytic_answers = 0
        self.escalations = 0

    # -- confidence model (characters->m_max regression over the cache) -----
    def refresh_model(self) -> Optional[Dict]:
        """(Re)fit the characters->m_max regression from every artifact in
        the port's cache directory; called lazily and after each escalation
        (every measured sweep is new history)."""
        results = []
        for path in artifact_cache.list_artifacts(self.cache_dir):
            try:
                with open(path) as f:
                    results.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
        points = FIT.collect_character_points(results)
        model = FIT.characters_regression(points)
        with self._lock:
            self._model = model
            self._model_stale = False
        return model

    @property
    def model(self) -> Optional[Dict]:
        with self._lock:
            stale = self._model_stale
        if stale:
            self.refresh_model()
        with self._lock:
            return self._model

    def confidence(self, ch: Optional[Dict], kind: str) -> Dict:
        """Confidence of an analytic answer for a probe with characters
        ``ch``.  Dataset probes consult the regression; gradient probes
        have no characters->m_max history and sit at the prior."""
        if kind == "dataset" and ch is not None:
            return FIT.analytic_confidence(self.model, ch)
        return {"confidence": FIT.CONFIDENCE_PRIOR, "source": "prior",
                "detail": "gradient-level probes carry no "
                          "characters->m_max history"}

    # -- tier 1: analytic answers from measured characters ------------------
    def analytic_dataset_report(self, ch: Dict, kwargs: Dict) -> Dict:
        """The `from_dataset` report built from pre-measured (batched)
        characters — identical formulas, so the batched answer matches
        the sequential one."""
        pc = kwargs.get("parallel_cost", self.parallel_cost)
        report = dict(ch)
        report["hogwild"] = FIT.predict_hogwild_from_characters(ch)
        report["sync"] = FIT.predict_sync_from_characters(
            ch, parallel_cost=pc)
        report["dadm"] = FIT.predict_dadm_from_characters(
            ch, parallel_cost=pc)
        report["momentum"] = FIT.predict_momentum_from_characters(
            ch, beta=kwargs.get("beta", 0.9), parallel_cost=pc)
        report["local_sgd"] = FIT.predict_local_sgd_from_characters(
            ch, sync_every=kwargs.get("sync_every", 4), parallel_cost=pc)
        report["svrg"] = FIT.predict_svrg_from_characters(
            ch, anchor_every=kwargs.get("anchor_every", 100))
        report["recommendation"] = self.advisor._recommend_dataset(report)
        report["valid"] = True
        with self._lock:
            self.analytic_answers += 1
        _ANALYTIC.inc()
        return report

    def analytic_grad_report(self, ch: Dict) -> Dict:
        """The `from_grads` report from pre-measured (batched) gradient
        characters — shares `_grad_report` so the answers are identical."""
        report = self.advisor._grad_report(dict(ch))
        with self._lock:
            self.analytic_answers += 1
        _ANALYTIC.inc()
        return report

    # -- tier 2: the measured sweep -----------------------------------------
    def escalation_spec(self, request) -> Optional[SweepSpec]:
        """The SweepSpec an escalated probe executes: the request's own
        sweep when it brought one, else a default probe sweep over its
        DatasetSpec.  None when the probe has no reproducible identity
        (raw arrays can't be fingerprinted into a spec)."""
        if getattr(request, "sweep", None) is not None:
            return request.sweep
        if getattr(request, "dataset", None) is None:
            return None
        return SweepSpec(
            name=f"service-{request.algorithm}",
            ms=self.sweep_ms, iters=self.sweep_iters,
            eval_every=self.sweep_eval_every,
            datasets={"probe": request.dataset},
            jobs=(JobSpec(algorithm=request.algorithm, dataset="probe",
                          kwargs=dict(request.kwargs), predict=True),),
            epsilon=EpsilonSpec(probe_m=2, frac=0.7))

    def escalate(self, request) -> Dict:
        """Run (or join) the measured sweep for an escalated probe.

        ``dedup=True`` collapses concurrent escalations sharing the
        fingerprint into one execution; the answer is then ALWAYS the
        stored artifact's bytes — the leader re-reads its own store — so
        every waiter receives the identical artifact."""
        sp = self.escalation_spec(request)
        assert sp is not None, "escalate() requires an escalatable request"
        fp = spec_mod.fingerprint(sp)
        with trace.span("escalate", spec=sp.name, fingerprint=fp[:12]):
            result = runner_mod.run_sweep(
                sp, device=self.device, cache_dir=self.cache_dir,
                dedup=True, cache_cap=self.cache_cap)
            art = artifact_cache.load(self.cache_dir, sp.name, fp) or result
        with self._lock:
            self.escalations += 1
            self._model_stale = True          # new measured history
        _ESCALATIONS.inc()
        job_key = next(iter(art.get("jobs", {})), None)
        for key in art.get("jobs", {}):
            if key.startswith(f"{request.algorithm}/"):
                job_key = key
                break
        job = art["jobs"].get(job_key, {}) if job_key else {}
        return {
            "sweep": sp.name,
            "fingerprint": fp,
            "artifact_path": artifact_cache.artifact_path(
                self.cache_dir, sp.name, fp),
            "cache_hit": bool(result.get("cache", {}).get("hit")),
            "job_key": job_key,
            "status": job.get("status", "ok"),
            "healthy": runner_mod.job_is_healthy(job) if job else False,
            "measured_m_max": job.get("measured_m_max"),
            "epsilon": job.get("epsilon"),
            "predicted": job.get("predicted"),
            "artifact": art,
        }

    def stats(self) -> Dict:
        with self._lock:
            return {"threshold": self.threshold,
                    "analytic_answers": self.analytic_answers,
                    "escalations": self.escalations,
                    "model": ("none" if self._model is None else
                              {"n_points": self._model["n_points"],
                               "r2": self._model["r2"],
                               "residual_rmse":
                                   self._model["residual_rmse"]})}
