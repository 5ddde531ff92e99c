"""Sweep specifications, the batched m-grid engine, the artifact cache,
the runner and the CLI (port of ``repro/experiments``)."""
