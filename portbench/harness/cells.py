"""A cell and its files, found by name: ``BENCHMARK.json`` names each cell's
configuration and traffic; ``portbench/configs/<config>.json`` holds the
configuration's sizes, ``portbench/traffic/<traffic>.json`` the mix's
parameters, ``portbench/limits/<cell>.json`` the limits of the numbers
the run compares, and ``portbench/metrics/<metric>.py`` the reader of each
per-layer metric (a function ``read(ctx)``).  The configuration's
``reference`` key names its reference kind (:mod:`.kinds`)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

from portbench.harness import kinds

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(root, "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict            # the configuration file
    traffic: dict        # the traffic file
    limits: dict         # the compared numbers' limits
    end_to_end: list     # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def load(name, root=ROOT):
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read
    from ``root/portbench``; a ValueError where its configuration names no
    reference kind that is present."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    pkg = os.path.join(root, "portbench")
    cfg = _json(pkg, "configs", entry["config"] + ".json")
    kinds.reference(cfg)
    return Cell(
        name=name, chips=entry["chips"], cfg=cfg,
        traffic=_json(pkg, "traffic", entry["traffic"] + ".json"),
        limits=_json(pkg, "limits", name + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric, root=ROOT):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(root=ROOT):
    return _json(root, "portbench", "peaks.json")
