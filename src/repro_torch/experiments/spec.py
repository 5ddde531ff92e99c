"""Declarative sweep specifications (port of ``repro/experiments/spec.py``).

A :class:`SweepSpec` names datasets (a registered generator plus kwargs
and a split policy), jobs ((algorithm, problem, dataset) cells), the
worker grid ``ms``, the iteration budget, an optional epsilon cost
readout and the seed count.  Its dict form is the reference's, so the
two packages' artifacts carry the same ``spec`` entry.

The :func:`fingerprint` keys the artifact cache.  It hashes the spec
dict, this package's ``ENGINE_VERSION``, the sources of the registry
entries the spec uses, and ``"backend": "torch"``, so a port artifact
can never answer a lookup of the reference, or the other way round.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
from typing import Dict, Optional, Tuple, Union

from repro_torch import random as R
from repro_torch.core import problems as problems_mod
from repro_torch.core.algorithms import base as alg_base
from repro_torch.data import synth

#: Hashed into every fingerprint; bump when engine numerics change.
#:   1: the first port slice (upper_bound on the batched torch engine)
ENGINE_VERSION = 1

BACKEND = "torch"

#: SweepSpec fields that steer execution only (where a sweep runs, never
#: what it computes): `computational_dict` drops them, so they enter
#: neither the fingerprint nor the stored artifact.
EXECUTION_ONLY_FIELDS = ("devices",)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One named dataset of a sweep: generator + kwargs + split policy."""
    generator: str                       # key in synth.GENERATORS
    kwargs: Dict = dataclasses.field(default_factory=dict)
    seed: int = 0                        # PRNGKey for the generator
    shuffle_split: bool = True           # False: keep sampling-sequence order
    variant: Optional[str] = None        # diversity: "high" | "mid" | "low"

    def validate(self):
        synth.get_generator(self.generator)   # raises KeyError if unknown
        if self.variant not in (None, "high", "mid", "low"):
            raise ValueError(f"bad diversity variant {self.variant!r}")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One (algorithm, problem, dataset) cell of the sweep grid."""
    algorithm: str
    dataset: str
    kwargs: Dict = dataclasses.field(default_factory=dict)  # e.g. gamma
    predict: bool = False                # run the theory-side m_max predictor
    predict_rows: int = 0                # rows of X fed to it (0 = all)
    problem: str = "logistic"
    label: Optional[str] = None          # disambiguates same-cell jobs

    @property
    def key(self) -> str:
        algo = (self.algorithm if self.label is None
                else f"{self.algorithm}[{self.label}]")
        if self.problem == "logistic":
            return f"{algo}/{self.dataset}"
        return f"{algo}+{self.problem}/{self.dataset}"

    def validate(self):
        alg_base.get_algorithm(self.algorithm)     # raises KeyError
        problems_mod.get_problem(self.problem)     # raises KeyError


@dataclasses.dataclass(frozen=True)
class EpsilonSpec:
    """Cost readout: eps = probe-run loss after ``frac`` of the budget."""
    probe_m: int = 2
    frac: float = 0.7


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    name: str
    description: str = ""
    ms: Tuple[int, ...] = (1, 2, 4, 8)
    iters: int = 1000
    eval_every: int = 100
    datasets: Dict[str, DatasetSpec] = dataclasses.field(default_factory=dict)
    jobs: Tuple[JobSpec, ...] = ()
    epsilon: Optional[EpsilonSpec] = None
    measure_csim: int = 0                # Eq. 3 range; 0 = skip
    csim_rows: int = 400                 # rows used for the C_sim estimate
    characters_rows: int = 0             # §IV summary rows; 0 = default cap
    split_seed: int = 0                  # key for shuffled splits
    n_seeds: int = 1                     # seed replicates per job
    #: execution only (`EXECUTION_ONLY_FIELDS`): the device mesh request
    #: `repro_torch.distributed.get_mesh` resolves — None = unsharded,
    #: "auto" = every available device, an int = that many
    devices: Optional[Union[int, str]] = None

    def validate(self) -> "SweepSpec":
        if not self.jobs:
            raise ValueError(f"spec {self.name!r} has no jobs")
        if self.devices is not None and self.devices != "auto" and (
                not isinstance(self.devices, int) or self.devices < 1):
            raise ValueError(f"spec {self.name!r}: devices={self.devices!r} "
                             f"must be None, 'auto', or a positive int")
        if len(set(self.ms)) != len(self.ms) or any(m < 1 for m in self.ms):
            raise ValueError(f"spec {self.name!r}: bad worker grid {self.ms}")
        if self.iters < self.eval_every or self.eval_every < 1:
            raise ValueError(f"spec {self.name!r}: iters={self.iters} "
                             f"eval_every={self.eval_every}")
        if self.n_seeds < 1:
            raise ValueError(f"spec {self.name!r}: n_seeds={self.n_seeds} "
                             f"must be >= 1")
        if self.epsilon is not None:
            if self.epsilon.probe_m not in self.ms:
                raise ValueError(
                    f"spec {self.name!r}: epsilon probe_m="
                    f"{self.epsilon.probe_m} must be in ms={self.ms}")
            if not 0.0 < self.epsilon.frac < 1.0:
                raise ValueError(f"spec {self.name!r}: epsilon frac="
                                 f"{self.epsilon.frac} must be in (0, 1)")
        for ds in self.datasets.values():
            ds.validate()
        for job in self.jobs:
            job.validate()
            if job.dataset not in self.datasets:
                raise KeyError(f"job {job.key!r} references unknown dataset")
        keys = [job.key for job in self.jobs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"spec {self.name!r}: duplicate job keys")
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _source_token(obj) -> str:
    """Content token for a registered class/function: hash of its source."""
    try:
        src = inspect.getsource(obj)
    except (OSError, TypeError):
        src = getattr(obj, "__qualname__", repr(obj))
    return hashlib.sha256(src.encode()).hexdigest()[:16]


def registry_signature(spec: SweepSpec) -> Dict[str, str]:
    """Source tokens for every registry entry the spec references; a
    wrapper generator's ``base`` generator (``label_noise``) is folded in
    too."""
    sig = {}
    for job in spec.jobs:
        sig[f"algorithm:{job.algorithm}"] = _source_token(
            alg_base.get_algorithm(job.algorithm))
        sig[f"problem:{job.problem}"] = _source_token(
            problems_mod.get_problem(job.problem))
    for ds in spec.datasets.values():
        name, kwargs = ds.generator, ds.kwargs
        while f"generator:{name}" not in sig:
            sig[f"generator:{name}"] = _source_token(
                synth.get_generator(name))
            base = kwargs.get("base")
            if not (isinstance(base, str) and base in synth.GENERATORS):
                break
            name, kwargs = base, {}
    return sig


def computational_dict(spec: SweepSpec) -> Dict:
    """``spec.to_dict()`` minus `EXECUTION_ONLY_FIELDS` and with unset job
    labels dropped — the same dict the reference persists for the same
    spec, and the one the fingerprint hashes."""
    d = spec.to_dict()
    for field in EXECUTION_ONLY_FIELDS:
        d.pop(field, None)
    for job in d["jobs"]:
        if job.get("label") is None:
            job.pop("label", None)
    return d


def fingerprint(spec: SweepSpec) -> str:
    """Content hash of a spec, the engine version, the registry sources it
    uses and the backend: the cache key."""
    payload = json.dumps({"backend": BACKEND,
                          "engine_version": ENGINE_VERSION,
                          "registries": registry_signature(spec),
                          "spec": computational_dict(spec)},
                         sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


def build_dataset(ds: DatasetSpec, device) -> synth.Dataset:
    """Materialize a DatasetSpec on ``device`` (its diversity variant,
    if any, applied)."""
    ds.validate()
    key = R.PRNGKey(ds.seed, device=device)
    data = synth.get_generator(ds.generator)(key, **ds.kwargs)
    if ds.variant is not None:
        high, mid, low = synth.make_diversity_variants(data)
        data = {"high": high, "mid": mid, "low": low}[ds.variant]
    return data


def split_dataset(ds_spec: DatasetSpec, data: synth.Dataset, split_seed: int):
    """70/20 split per the spec's policy (shuffled unless sequence-ordered;
    the 10% held-out tail stays untouched)."""
    if ds_spec.shuffle_split:
        return data.split(key=R.PRNGKey(split_seed, device=data.X.device))
    return data.split()
