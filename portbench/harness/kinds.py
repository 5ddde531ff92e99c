"""A configuration's reference kind, found by the name in its
``reference`` key: a module of :mod:`portbench.reference` that exports
:data:`NAMES`, with a twin of the same name in :mod:`portbench.counts`
that exports ``terms(cfg, seq)``, its model FLOPs per token by term.

  param_specs(cfg)    the weight tree's leaves, ``(shape, dtype, init)``
  layer_kinds(cfg)    each layer's kind, as the port's ``layer_plan`` has it
  program_sizes(cfg)  {dotted attribute path of the port's ``ArchConfig``:
                       the value the configuration file gives}
  Arith(fp8=False)    the reference's precision (``fp8``: the control)
  run_sync(params, batches, cfg, traffic, ar)
                      AdamW steps from ``params``: ``{"loss", "grad_norm"}``

A model of a new kind adds ``reference/<kind>.py`` and ``counts/<kind>.py``
and names the kind in its configuration; the harness edits nothing."""

from __future__ import annotations

import importlib
import pkgutil

from portbench import counts as _counts
from portbench import reference as _reference

NAMES = ("param_specs", "layer_kinds", "program_sizes", "Arith", "run_sync")


def present():
    """The kinds there are: the reference modules with a counts twin."""
    have = {m.name for m in pkgutil.iter_modules(_counts.__path__)}
    return sorted(m.name for m in pkgutil.iter_modules(_reference.__path__)
                  if m.name in have)


def _module(cfg, pkg, names):
    kind = cfg.get("reference")
    if kind not in present():
        raise ValueError(f"configuration {cfg.get('name')!r} names the "
                         f"reference kind {kind!r}; the kinds present: "
                         f"{present()}")
    mod = importlib.import_module(f"{pkg.__name__}.{kind}")
    missing = [n for n in names if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"{mod.__name__} lacks {missing}")
    return mod


def reference(cfg):
    """``portbench/reference/<kind>.py`` of ``cfg``'s kind."""
    return _module(cfg, _reference, NAMES)


def counts(cfg):
    """``portbench/counts/<kind>.py`` of ``cfg``'s kind."""
    return _module(cfg, _counts, ("terms",))
