"""repro_torch.service — the scalability advisor as a long-lived service
(port of ``repro/service``).

  * `batcher` coalesces concurrent dataset-character probes into one
    masked-batch call on a `serve.SlotDriver` (K1 counts every row
    support of the slot batch in one launch on the GPU),
  * `tiers` answers from the analytic predictors when the confidence of
    the characters->m_max regression allows, and escalates the rest to a
    measured sweep through `experiments.runner.run_sweep(dedup=True)`,
  * `queue` bounds admission — overflow is shed with structured
    ``overloaded`` responses,
  * `http` serves it all over HTTP with the telemetry endpoints.

`api.AdvisorService` wires them together on a device (the GPU unless the
caller asks for the CPU); ``python -m repro_torch.service`` is the CLI.
"""

from repro_torch.service.api import (AdvisorService, ProbeRequest,  # noqa: F401
                                     ProbeResponse)
