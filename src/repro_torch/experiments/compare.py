"""Compare two sweep artifacts of the same spec, e.g. the port's on the
GPU against the reference's (both written with ``--json``):

    python -m repro_torch.experiments.compare port.json reference.json

Prints, per dataset, the largest relative difference of the §IV
characters and, per job, the largest absolute curve difference, epsilon
and the measured and predicted m_max of both.  Exits 1 if the two
artifacts describe different specs.
"""

from __future__ import annotations

import json
import sys


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def compare(a: dict, b: dict) -> dict:
    if a["spec"] != b["spec"]:
        raise ValueError("the artifacts describe different specs")
    out = {"datasets": {}, "jobs": {}}
    for name, info in a["datasets"].items():
        ca, cb = info["characters"], b["datasets"][name]["characters"]
        out["datasets"][name] = max(_rel(ca[k], cb[k]) for k in ca)
    for key, ja in a["jobs"].items():
        jb = b["jobs"][key]
        diff = max(abs(x - y) for ra, rb in zip(ja["losses"], jb["losses"])
                   for x, y in zip(ra, rb))
        out["jobs"][key] = {
            "max_abs_curve_diff": diff,
            "epsilon": [ja.get("epsilon"), jb.get("epsilon")],
            "measured_m_max": [ja.get("measured_m_max"),
                               jb.get("measured_m_max")],
            "predicted_m_max": [
                j.get("predicted", {}).get("predicted_m_max")
                for j in (ja, jb)],
        }
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        a = json.load(f)
    with open(argv[1]) as f:
        b = json.load(f)
    try:
        report = compare(a, b)
    except ValueError as e:
        print(f"compare: {e}", file=sys.stderr)
        return 1
    for name, rel in report["datasets"].items():
        print(f"dataset {name}: max relative character difference {rel:.3g}")
    for key, row in report["jobs"].items():
        print(f"job {key}: {json.dumps(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
