"""The port's paper report and bench trajectory against the reference's.

Both packages' ``report.main`` run at ``--quick --iters 40 --n 120
--seeds 2``, each with a fresh cache of its own.  Sections 1-5 must read
the same, line for line; only ECD-PSGD's lines may differ, and then only
in their numbers, each held to the ECD-PSGD envelope of 2e-2 (relative
to the larger of 1 and the value; an integer m_max therefore equal).  A
second render is served from the port's cache.  The trajectory over the
repository's ``BENCH_*.json`` gives the same points, verdict and
markdown.  Each ``main`` installs its package's process-wide tracer for
section 6; the fixture puts both tracers back as it found them, so that
no later test in the worker (the reference's ``/trace`` endpoint test
among them) serves the reports' spans."""

import os
import re

import pytest

from repro.analysis import report as ref_report
from repro.analysis import trajectory as ref_trajectory
from repro.telemetry import trace as ref_trace
from repro_torch.analysis import report, trajectory
from repro_torch.experiments import cache as artifact_cache
from repro_torch.telemetry import trace

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
ARGS = ["--quick", "--iters", "40", "--n", "120", "--seeds", "2"]
ECD_TOL = 2e-2
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("report")
    out = {}
    tracers = {mod: (mod._ACTIVE, mod._LAST) for mod in (ref_trace, trace)}
    try:
        for name, main, extra in (("ref", ref_report.main, []),
                                  ("port", report.main,
                                   ["--device", "cpu"])):
            path = tmp / f"{name}.md"
            assert main(ARGS + extra + ["--out", str(path), "--cache-dir",
                                        str(tmp / f"{name}_cache")]) == 0
            out[name] = path.read_text()
    finally:
        for mod, (active, last) in tracers.items():
            mod._ACTIVE, mod._LAST = active, last
    out["tmp"] = tmp
    return out


def _sections_1_to_5(md):
    lines = md.splitlines()
    lo = lines.index("## 1. Table II, replicated (`upper_bound`)")
    hi = lines.index("## 6. where the time went (span trace)")
    return lines[lo:hi]


def _numbers_close(a, b):
    na, nb = _NUMBER.findall(a), _NUMBER.findall(b)
    if len(na) != len(nb) or _NUMBER.sub("#", a) != _NUMBER.sub("#", b):
        return False
    return all(abs(float(x) - float(y))
               <= ECD_TOL * max(1.0, abs(float(x)), abs(float(y)))
               for x, y in zip(na, nb))


def test_sections_1_to_5_equal_the_reference(reports):
    mine = _sections_1_to_5(reports["port"])
    ref = _sections_1_to_5(reports["ref"])
    assert len(mine) == len(ref)
    assert [ln for ln in mine if ln.startswith("## ")] == \
        [f"## {i}. {t}" for i, t in enumerate((
            "Table II, replicated (`upper_bound`)",
            "Character surface (`character_surface`)",
            "Critical-parameter surface (`critical_params`)",
            "Fault tolerance (`fault_tolerance`)",
            "characters &#8594; m_max regression"), start=1)]
    for a, b in zip(mine, ref):
        if a == b:
            continue
        assert "ecd_psgd" in b, (a, b)
        # a sparkline may flip a block where ECD-PSGD's curves differ by
        # an ulp-born quantum: compare the numbers, not the glyphs
        strip = re.compile("[▁-█]")
        assert _numbers_close(strip.sub("", a), strip.sub("", b)), (a, b)


def test_section_6_attributes_the_ports_spans(reports):
    md = reports["port"]
    assert "`repro_torch.telemetry.trace`" in md
    m = re.search(r"wall-clock, (\d+)% attributed", md)
    assert m and int(m.group(1)) >= 95
    for phase in ("| job |", "| grid |", "| bucket |", "| execute |",
                  "| datasets |", "| store |"):
        assert phase in md


def test_rerender_is_served_from_cache(reports, capsys):
    tmp = reports["tmp"]
    path = tmp / "again.md"
    assert report.main(ARGS + ["--device", "cpu", "--out", str(path),
                               "--cache-dir", str(tmp / "port_cache")]) == 0
    out = capsys.readouterr().out
    assert out.count("jobs (cache)") == len(report.REPORT_SPECS)
    again = path.read_text()
    assert _sections_1_to_5(again) == _sections_1_to_5(reports["port"])
    assert "every sweep above was served from the artifact cache" in again


def test_defaults_stay_off_the_reference_paths():
    assert report.DEFAULT_OUT != ref_report.DEFAULT_OUT
    assert report.DEFAULT_OUT.endswith("analysis_report_torch.md")
    assert artifact_cache.DEFAULT_CACHE_DIR.endswith("sweep_cache_torch") \
        or "REPRO_TORCH_SWEEP_CACHE" in os.environ
    assert report.REPORT_SPECS == ref_report.REPORT_SPECS
    assert report.DEFAULT_SEEDS == ref_report.DEFAULT_SEEDS


def test_regression_reads_only_the_ports_cache(reports):
    """Section 5's points come from the cache directory given, and the
    port's artifacts carry the port's backend."""
    cached = report.load_cached_results(str(reports["tmp"] / "port_cache"))
    assert len(cached) == len(report.REPORT_SPECS)
    assert all(r.get("backend") == "torch" for r in cached)
    assert report.load_cached_results(str(reports["tmp"] / "nowhere")) == []


@pytest.mark.parametrize("values", [[3.0, 1.0, 2.0, 2.0], [5.0], [1.5, 1.5]])
def test_presentation_helpers_match_reference(values):
    assert report.sparkline(values) == ref_report.sparkline(values)
    labels = [str(i) for i in range(len(values))]
    assert report.svg_timeseries(labels, values, title="t") == \
        ref_report.svg_timeseries(labels, values, title="t")
    if len(values) > 1:
        ms = [2 ** i for i in range(len(values))]
        lo = [v - 0.5 for v in values]
        hi = [v + 0.5 for v in values]
        assert report.svg_cost_curve(ms, values, lo, hi, title="c") == \
            ref_report.svg_cost_curve(ms, values, lo, hi, title="c")


def test_trajectory_matches_reference():
    mine = trajectory.load_trajectory(ROOT)
    ref = ref_trajectory.load_trajectory(ROOT)
    assert mine and mine == ref
    for band in (2.0, 1.01):
        verdict = trajectory.check_regression(mine, band=band)
        assert verdict == ref_trajectory.check_regression(ref, band=band)
        assert trajectory.render_history(mine, verdict) == \
            ref_trajectory.render_history(ref, verdict)
    assert trajectory.check_regression(mine[:1]) == \
        ref_trajectory.check_regression(ref[:1])
