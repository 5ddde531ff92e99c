"""Sweep specifications, the batched m-grid engine, the artifact cache,
the runner and the CLI (port of ``repro/experiments``)."""

from repro_torch.experiments.registry import SPEC_IDS, get_spec
from repro_torch.experiments.runner import curves_by_m, run_sweep
from repro_torch.experiments.spec import (ALGORITHMS, PROBLEMS,
                                          DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec, fingerprint,
                                          registry_signature)

__all__ = ["SPEC_IDS", "get_spec", "run_sweep", "curves_by_m", "ALGORITHMS",
           "PROBLEMS", "DatasetSpec", "EpsilonSpec", "JobSpec", "SweepSpec",
           "fingerprint", "registry_signature"]
