"""Fault injection for parallel-training update streams
(``faults.py``, port of ``repro/resilience/faults.py``) and the runner's
per-job crash journal (``journal.py``, port of
``repro/resilience/journal.py``)."""

from repro_torch.resilience.faults import (FaultSpec, corrupt,
                                           delivery_scale, make_stream,
                                           resolve)
from repro_torch.resilience.journal import (append_entry, consume,
                                            journal_path, read_entries)

__all__ = [
    "FaultSpec", "resolve", "make_stream", "delivery_scale", "corrupt",
    "journal_path", "append_entry", "read_entries", "consume",
]
