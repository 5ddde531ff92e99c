"""repro_torch.analysis — seed-replicated statistics, scaling-law fits and
the paper report (port of ``repro/analysis``).

  `stats`       per-(job, m) mean/std/bootstrap-CI curves, seed-replicated
                per-worker costs and a bootstrap distribution over the
                measured m_max
  `fit`         least-squares fits of the Thm-2/Thm-3 cost laws, the
                characters -> m_max regression and the theory-side m_max
                predictors
  `report`      ``python -m repro_torch.analysis.report``: the markdown
                report (bootstrap-CI Table II, surfaces, fault tolerance,
                regression, where the time went)
  `trajectory`  every ``BENCH_N.json`` anchor as one series, its gates and
                its markdown

`report` imports `repro_torch.experiments` and is therefore not imported
here: the runner and the advisor import `stats` and `fit` without a cycle.
"""

from repro_torch.analysis import fit, stats

__all__ = ["fit", "stats"]
