"""Per-job crash journal for `repro_torch.experiments.runner.run_sweep`
(port of ``repro/resilience/journal.py``).

Layout: ``<cache_dir>/<spec-name>-<fingerprint16>.journal.jsonl``, beside
the artifact it protects (the port's cache directory, so the reference's
journals are never read) — one JSON object per line, appended and
fsync'd the moment a job finishes:

    {"fingerprint": "<full sha256>", "key": "<job.key>", "job": {...}}

``job`` is the job's finished result dict — readouts, predictions and
``status`` attached — exactly the object the final artifact will carry.
JSON floats round-trip exactly (shortest repr), so a re-run that replays
journal entries instead of recomputing them produces a byte-identical
artifact.

A crash mid-append leaves at most one partial trailing line;
:func:`read_entries` skips unparsable lines and entries of another
fingerprint, so a stale or torn journal can only cause recomputation,
never a wrong resume.  The runner deletes the journal once the final
artifact is stored.
"""

from __future__ import annotations

import json
import os
from typing import Dict


def journal_path(cache_dir: str, name: str, fp: str) -> str:
    """Sibling of the artifact the journal is protecting (the
    ``<name>-<fp16>`` naming of `experiments.cache.artifact_path`; not
    imported from there, so `repro_torch.resilience` stays importable
    from `core.algorithms` without the experiments package)."""
    return os.path.join(cache_dir, f"{name}-{fp[:16]}.journal.jsonl")


def append_entry(path: str, fp: str, key: str, job: Dict) -> None:
    """Durably append one completed job (flush + fsync: a SIGKILL right
    after this call must still find the entry on disk)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    line = json.dumps({"fingerprint": fp, "key": key, "job": job},
                      default=float)
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())


def read_entries(path: str, fp: str) -> Dict[str, Dict]:
    """``{job key: job result}`` for every intact entry matching ``fp``.
    Missing file, torn trailing lines, and foreign fingerprints all
    degrade to "not journaled" (the job just recomputes)."""
    out: Dict[str, Dict] = {}
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        try:
            entry = json.loads(line)
        except json.JSONDecodeError:
            continue                      # torn write — skip
        if (isinstance(entry, dict) and entry.get("fingerprint") == fp
                and isinstance(entry.get("job"), dict)
                and isinstance(entry.get("key"), str)):
            out[entry["key"]] = entry["job"]
    return out


def consume(path: str) -> None:
    """Remove the journal (called after the final artifact is stored —
    the artifact now supersedes it)."""
    try:
        os.unlink(path)
    except OSError:
        pass
