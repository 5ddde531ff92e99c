"""Fault injection for parallel-training update streams
(``faults.py``, port of ``repro/resilience/faults.py``) and the runner's
per-job crash journal (``journal.py``, port of
``repro/resilience/journal.py``)."""
