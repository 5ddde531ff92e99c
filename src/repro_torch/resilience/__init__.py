"""Fault injection for parallel-training update streams (port of
``repro/resilience/faults.py``)."""
