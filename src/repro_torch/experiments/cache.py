"""Content-hashed on-disk artifact cache for the port's sweep results
(port of ``repro/experiments/cache.py``).

Layout: ``<cache_dir>/<spec-name>-<fingerprint16>.json``.  The default
directory is the port's own, ``results/sweep_cache_torch`` (override with
``REPRO_TORCH_SWEEP_CACHE`` or the ``cache_dir`` argument), and the
fingerprint carries the backend, so port and reference artifacts never
serve each other.  Per-run keys (`VOLATILE_KEYS`: hit info, execution
report, ``elapsed_s`` and the per-job ``timings``) are not persisted.

**Integrity**: :func:`store` embeds a sha256 ``checksum`` of the
canonical payload serialization; :func:`load` verifies it and
quarantines an artifact that fails — renamed to ``<path>.corrupt`` with
a warning — instead of serving it.  Artifacts without a ``checksum``
(written before the port had one) still load unverified.

**Size cap**: ``store(max_artifacts=)`` — or the
``REPRO_TORCH_SWEEP_CACHE_CAP`` environment variable — holds the
directory to that many artifacts with least-recently-*used* eviction
(:func:`load` bumps an artifact's mtime on every hit).  An evicted
sweep recomputes into byte-identical bytes on its next request.

**In-flight dedup** (:class:`InFlightTable`): concurrent callers racing
to compute one fingerprint collapse into one execution — the first
caller leases the fingerprint and computes, the rest wait and then load
the stored artifact.  `runner.run_sweep(dedup=True)` is the consumer;
`repro_torch.service` routes every escalated sweep through it.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import warnings
from typing import Dict, List, Optional

from repro_torch.telemetry import metrics

DEFAULT_CACHE_DIR = os.environ.get(
    "REPRO_TORCH_SWEEP_CACHE", os.path.join("results", "sweep_cache_torch"))

_HITS = metrics.counter("repro_cache_hits_total",
                        help="artifact cache lookups served from disk")
_MISSES = metrics.counter("repro_cache_misses_total",
                          help="artifact cache lookups that missed")
_EVICTIONS = metrics.counter("repro_cache_evictions_total",
                             help="artifacts evicted by the LRU cap")
_QUARANTINES = metrics.counter(
    "repro_cache_quarantines_total",
    help="artifacts quarantined after failing integrity verification")
_STORES = metrics.counter("repro_cache_stores_total",
                          help="artifacts written (atomic replace)")

#: default artifact-count cap applied by `store` (0 / unset = unbounded;
#: long-lived services should set a cap)
DEFAULT_CACHE_CAP: Optional[int] = (
    int(os.environ.get("REPRO_TORCH_SWEEP_CACHE_CAP", "0")) or None)

#: result keys describing one concrete run, not the computation — never
#: persisted, re-attached fresh by the runner after every load/store
VOLATILE_KEYS = ("cache", "execution", "elapsed_s", "timings")


def artifact_path(cache_dir: str, name: str, fp: str) -> str:
    return os.path.join(cache_dir, f"{name}-{fp[:16]}.json")


def _payload_checksum(payload: Dict) -> str:
    """sha256 of the canonical (sorted-key) serialization, ``checksum``
    excluded.  JSON floats round-trip via shortest repr, so a parsed
    payload re-serializes to the same canonical bytes — verification
    after `json.load` is exact."""
    body = {k: v for k, v in payload.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=float).encode()).hexdigest()


def _quarantine(path: str, reason: str) -> None:
    corrupt = path + ".corrupt"
    _QUARANTINES.inc()
    try:
        os.replace(path, corrupt)
    except OSError:
        corrupt = path                      # couldn't move; report in place
    warnings.warn(
        f"sweep artifact {path} failed integrity verification ({reason}); "
        f"quarantined to {corrupt} — the sweep will recompute",
        RuntimeWarning, stacklevel=3)


def load(cache_dir: str, name: str, fp: str) -> Optional[Dict]:
    """Return the cached payload, or None on miss.  Unparsable or
    checksum-mismatching artifacts are quarantined (see module docs).
    A hit bumps the artifact's mtime, so LRU eviction (`enforce_cap`)
    tracks use, not write order."""
    path = artifact_path(cache_dir, name, fp)
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        _MISSES.inc()
        return None
    try:
        payload = json.loads(raw)
    except json.JSONDecodeError:
        _quarantine(path, "not parseable as JSON — truncated write?")
        _MISSES.inc()
        return None
    if payload.get("fingerprint") != fp:      # foreign / stale artifact
        _MISSES.inc()
        return None
    if "checksum" in payload and (
            payload["checksum"] != _payload_checksum(payload)):
        _quarantine(path, "payload checksum mismatch — bit rot or a "
                          "hand-edited artifact")
        _MISSES.inc()
        return None
    try:
        os.utime(path, None)                  # recency = last use
    except OSError:
        pass
    _HITS.inc()
    return payload


def list_artifacts(cache_dir: str) -> List[str]:
    """Paths of every artifact in the cache directory, least-recently-used
    first (quarantined ``.corrupt`` files and write temps excluded)."""
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return []
    paths = [os.path.join(cache_dir, n) for n in names
             if n.endswith(".json")]
    def mtime(p):
        try:
            return os.stat(p).st_mtime
        except OSError:
            return 0.0
    return sorted(paths, key=mtime)


_EVICTION_WARNED = False


def enforce_cap(cache_dir: str, max_artifacts: int,
                keep: Optional[str] = None) -> List[str]:
    """Evict least-recently-used artifacts until at most ``max_artifacts``
    remain; returns the evicted paths.  ``keep`` (the artifact just
    stored) is never evicted.  The first eviction of the process warns
    once — a service whose working set exceeds its cache cap is
    recomputing sweeps it could have kept."""
    global _EVICTION_WARNED
    evicted: List[str] = []
    arts = list_artifacts(cache_dir)
    excess = len(arts) - int(max_artifacts)
    for path in arts:
        if excess <= 0:
            break
        if keep is not None and os.path.abspath(path) == \
                os.path.abspath(keep):
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        evicted.append(path)
        _EVICTIONS.inc()
        excess -= 1
    if evicted and not _EVICTION_WARNED:
        _EVICTION_WARNED = True
        warnings.warn(
            f"sweep cache {cache_dir} exceeded its cap of "
            f"{max_artifacts} artifact(s); evicted {len(evicted)} "
            f"least-recently-used (first: {evicted[0]}).  Evicted sweeps "
            f"recompute to byte-identical artifacts on the next request; "
            f"raise the cap (REPRO_TORCH_SWEEP_CACHE_CAP / max_artifacts) "
            f"if "
            f"this working set should stay resident.  [warned once]",
            RuntimeWarning, stacklevel=3)
    return evicted


def store(cache_dir: str, name: str, fp: str, payload: Dict,
          max_artifacts: Optional[int] = None) -> str:
    """Atomically write the payload; returns the artifact path.
    Volatile per-run keys (`VOLATILE_KEYS`) are stripped so the artifact
    bytes do not depend on where or how fast it was computed; a payload
    checksum is embedded for `load` to verify.
    ``max_artifacts`` (default: `DEFAULT_CACHE_CAP`) bounds the directory
    with LRU eviction after the write."""
    os.makedirs(cache_dir, exist_ok=True)
    path = artifact_path(cache_dir, name, fp)
    payload = {k: v for k, v in payload.items() if k not in VOLATILE_KEYS}
    payload["fingerprint"] = fp
    payload["checksum"] = _payload_checksum(payload)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, default=float)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _STORES.inc()
    cap = max_artifacts if max_artifacts is not None else DEFAULT_CACHE_CAP
    if cap is not None and cap > 0:
        enforce_cap(cache_dir, cap, keep=path)
    return path


# ---------------------------------------------------------------------------
# in-flight dedup (single-flight execution per fingerprint)
# ---------------------------------------------------------------------------

class InFlightTable:
    """Single-flight table keyed by sweep fingerprint.

    The first caller to :meth:`lease` a fingerprint becomes its *leader*
    (computes and stores the artifact); concurrent callers see ``False``,
    :meth:`wait`, then re-check the artifact cache — the leader's stored
    bytes serve every waiter, so N identical concurrent requests execute
    exactly one sweep and every waiter reads the identical artifact.  A
    leader that fails releases without storing; one waiter then takes
    over the lease (graceful retry, never a deadlock)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[str, threading.Event] = {}

    def lease(self, fp: str) -> bool:
        """True -> caller is the leader for ``fp`` and must `release`."""
        with self._lock:
            if fp in self._events:
                return False
            self._events[fp] = threading.Event()
            return True

    def wait(self, fp: str, timeout: Optional[float] = None) -> bool:
        """Block until ``fp``'s leader releases (True), or timeout
        (False).  Returns immediately when nothing is in flight."""
        with self._lock:
            ev = self._events.get(fp)
        if ev is None:
            return True
        return ev.wait(timeout)

    def release(self, fp: str) -> None:
        """Leader done (artifact stored, or the attempt failed): wake
        every waiter and free the lease."""
        with self._lock:
            ev = self._events.pop(fp, None)
        if ev is not None:
            ev.set()

    @property
    def n_inflight(self) -> int:
        with self._lock:
            return len(self._events)
