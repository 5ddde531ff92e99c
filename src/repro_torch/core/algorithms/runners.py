"""The reference's deprecated per-m runners (``run_minibatch``,
``run_hogwild``, ``run_ecd_psgd``, ``run_dadm``): one logistic
regression run at one worker count ``m``, returned with the reference's
``{"algorithm", "m", "iters", "eval_every", "losses",
"iters_per_worker"}`` contract.  Each is a thin adapter over
`repro_torch.experiments.engine` (a one-member grid); the reference's
``"x"`` (the final model) is not part of the engine's output and is left
out.  Sweeps should call the engine."""

from __future__ import annotations

import warnings

from repro_torch.core.algorithms.lr import LAMBDA


def _one(name, train, test, m, iters, eval_every, key, per_worker,
         **kwargs):
    from repro_torch.experiments import engine
    out = engine.sweep(name, train, test, [m], iters=iters,
                       eval_every=eval_every, key=key, **kwargs)
    return {"algorithm": name, "m": m, "iters": iters,
            "eval_every": eval_every, "losses": out["losses"][0],
            "iters_per_worker": per_worker}


def run_minibatch(train, test, *, m=None, iters=4000, gamma=0.1,
                  lam=LAMBDA, eval_every=100, key=None, batch_size=None):
    """Mini-batch SGD at ``m`` workers (default 4); ``batch_size`` is the
    old name of ``m`` (Fact 1), kept with a warning."""
    if batch_size is not None:
        warnings.warn(
            "run_minibatch(batch_size=...) is deprecated; the degree of "
            "parallelism is named m=... like the other algorithms (Fact 1: "
            "batch size IS the worker count)", DeprecationWarning,
            stacklevel=2)
        if m is not None and m != batch_size:
            raise TypeError(f"conflicting worker counts: m={m} "
                            f"batch_size={batch_size}")
        m = batch_size
    m = 4 if m is None else m
    return _one("minibatch", train, test, m, iters, eval_every, key, iters,
                lam=lam, gamma=gamma)


def run_hogwild(train, test, *, m=4, iters=4000, gamma=0.1, lam=LAMBDA,
                eval_every=100, key=None):
    """Hogwild! at ``m`` workers (server-iteration-indexed curve)."""
    return _one("hogwild", train, test, m, iters, eval_every, key,
                iters / m, lam=lam, gamma=gamma)


def run_ecd_psgd(train, test, *, m=4, iters=4000, gamma=0.1, lam=LAMBDA,
                 eval_every=100, compress_bits=8, key=None):
    """ECD-PSGD at ``m`` workers on a ring."""
    return _one("ecd_psgd", train, test, m, iters, eval_every, key, iters,
                lam=lam, gamma=gamma, compress_bits=compress_bits)


def run_dadm(train, test, *, m=4, local_batch=8, iters=2000, lam=LAMBDA,
             eval_every=100, key=None):
    """DADM at ``m`` workers, ``local_batch`` dual coordinates each."""
    return _one("dadm", train, test, m, iters, eval_every, key, iters,
                lam=lam, local_batch=local_batch)
