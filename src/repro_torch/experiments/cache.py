"""Content-hashed on-disk artifact cache for the port's sweep results
(``load``, ``store`` and ``artifact_path`` of ``repro/experiments/
cache.py``).

Layout: ``<cache_dir>/<spec-name>-<fingerprint16>.json``.  The default
directory is the port's own, ``results/sweep_cache_torch`` (override with
``REPRO_TORCH_SWEEP_CACHE`` or the ``cache_dir`` argument), and the
fingerprint carries the backend, so port and reference artifacts never
serve each other.  Per-run keys (`VOLATILE_KEYS`) are not persisted.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

DEFAULT_CACHE_DIR = os.environ.get(
    "REPRO_TORCH_SWEEP_CACHE", os.path.join("results", "sweep_cache_torch"))

#: result keys describing one concrete run, never persisted
VOLATILE_KEYS = ("cache", "execution", "elapsed_s", "timings")


def artifact_path(cache_dir: str, name: str, fp: str) -> str:
    return os.path.join(cache_dir, f"{name}-{fp[:16]}.json")


def load(cache_dir: str, name: str, fp: str) -> Optional[Dict]:
    """Return the cached payload, or None on a miss (no file, unreadable
    JSON, or an artifact of another fingerprint)."""
    path = artifact_path(cache_dir, name, fp)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if payload.get("fingerprint") != fp:
        return None
    return payload


def store(cache_dir: str, name: str, fp: str, payload: Dict) -> str:
    """Atomically write the payload without its volatile keys; returns
    the artifact path."""
    os.makedirs(cache_dir, exist_ok=True)
    path = artifact_path(cache_dir, name, fp)
    payload = {k: v for k, v in payload.items() if k not in VOLATILE_KEYS}
    payload["fingerprint"] = fp
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, default=float)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
