"""A training cell's run: the port's step built once, driven through its
first steps (the checked steps, which warm every shape up too), then the
measured window, then the comparison with the reference.

Set-up builds the weights and a pool of distinct batches from the seed,
hands the weights to the port (``interop.lm_params``, then
``train.steps.init_train_state``) and takes the step of
``make_train_step``.  The first ``checked_steps`` steps, on the pool's
first batches, are read for the comparison (each loss, the first
gradient from AdamW's first moment, each leaf's change after the last of
them); ``warmup_steps`` more follow.  The window then runs whole steps on
the next batches of the pool, each loss read as it comes, until
``seconds`` have passed.  After it the port's state is freed and the
reference runs the checked steps again from the same weights and
batches.
"""

from __future__ import annotations

import gc
import math
import time
import types

import torch

from portbench.harness import compare, inputs, kinds
from portbench.harness import trace as TR
from portbench.reference import steps as RS
from portbench.reference.trees import leaves


def _attr(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name, None)
    return obj


def program_arch(cfg):
    """The port's ``ArchConfig`` of the configuration, the sizes and layer
    kinds of its reference kind checked against the port's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    ref = kinds.reference(cfg)
    a = get_arch(cfg["arch"])
    want = ref.program_sizes(cfg)
    got = {k: _attr(a, k) for k in want}
    plan = [s.kind for s in M.layer_plan(a)]
    if got != want or plan != ref.layer_kinds(cfg):
        raise ValueError(f"the port's {cfg['arch']} is not the "
                         f"configuration file's: {got} {plan}")
    return a


class Program:
    """The system under test: the port's state and step, and the feed."""

    def __init__(self, cfg, traffic, arch, seed, device):
        from repro_torch import interop
        from repro_torch.train import steps as S
        if traffic["strategy"] != "sync":
            raise ValueError(f"strategy {traffic['strategy']!r}")
        self.traffic = traffic
        w = inputs.weights(cfg, seed, device)
        model = interop.lm_params(arch, w, device)
        self.state = S.init_train_state(arch, "sync", params=model,
                                        device=device)
        self.step_fn = S.make_train_step(arch, strategy="sync",
                                         lr=traffic["lr"],
                                         remat=traffic["remat"])
        del w, model
        self.pool = inputs.batches(traffic, cfg["vocab_size"], seed, device)
        self.i = 0

    def feed(self):
        tokens, labels = self.pool[self.i % len(self.pool)]
        self.i += 1
        return {"tokens": tokens, "labels": labels}

    def step(self):
        """One whole step; its loss as a float (waits for the step)."""
        self.state, m = self.step_fn(self.state, self.feed())
        return float(m["loss"])


def checked_steps(prog, cfg, seed, device):
    """The program's readings of its first steps (see the module)."""
    tr = prog.traffic
    out = {"loss": []}
    for k in range(tr["checked_steps"]):
        out["loss"].append(prog.step())
        if k == 0:
            b1 = tr["adamw"]["b1"]
            out["grad_norm"] = {p: RS.norm(m) / (1 - b1)
                                for p, m in leaves(prog.state["opt"]["m"])}
    w0 = inputs.weights(cfg, seed, device)
    out["change"] = RS.change_norms(prog.state["params"], w0)
    del w0
    for _ in range(tr["warmup_steps"]):
        prog.step()
    return out


def reference(cfg, traffic, batches, seed, device, fp8=False):
    """The reference's readings of the checked steps (float32, TF32 off;
    ``fp8``: the lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = kinds.reference(cfg)
    w = inputs.weights(cfg, seed, device)
    out = ref.run_sync(w, batches, cfg, traffic, ref.Arith(fp8=fp8))
    w0 = inputs.weights(cfg, seed, device)
    out["change"] = RS.change_norms(w, w0)
    return out


#: what a per-layer metric reader reads: ``cell``, ``trace`` (a
#: :class:`trace.Trace`), ``tokens_per_step``, ``flops_per_token``,
#: ``peaks``, ``device``
Ctx = types.SimpleNamespace


def run(cell, seed, seconds, traced, device, t0, arch=None, peaks=None,
        readers=None):
    """One run of a training cell: the result's fields (without its
    ``device`` and the checks' limits applied by the caller)."""
    from repro_torch import kernels
    from portbench.counts import flops
    cfg, tr = cell.cfg, cell.traffic
    arch = arch or program_arch(cfg)
    cuda = torch.device(device).type == "cuda"
    prog = Program(cfg, tr, arch, seed, device)
    mine = checked_steps(prog, cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    tokens = tr["batch"] * tr["seq"]
    res = {"metrics": {}}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    if not traced:
        losses = []
        start = time.perf_counter()
        res["setup_s"] = start - t0
        while True:
            losses.append(prog.step())
            if time.perf_counter() - start >= seconds:
                break
        res["window_s"] = time.perf_counter() - start
        res["metrics"]["train_tokens_per_s"] = \
            len(losses) * tokens / res["window_s"]
    else:
        losses = []

        def steps(k):
            for _ in range(k):
                losses.append(prog.step())
        t = TR.traced(steps, tr["trace_steps"])
        # one step more with the host's operators recorded, which slows
        # the host: it only names what the host did in each idle gap
        gaps = TR.traced(steps, 1, host=True).breakdown()["idle_gaps"]
        ctx = Ctx(cell=cell, trace=t, tokens_per_step=tokens,
                  flops_per_token=flops.per_token(cfg, tr["seq"]),
                  peaks=peaks, device=device)
        for m in cell.per_layer:
            v = readers[m["name"]](ctx)
            if v is not None:
                res["metrics"][m["name"]] = v
        res["busy_s"], res["window_s"] = t.busy_s(), t.window_s
        res["breakdown"] = dict(t.breakdown(), idle_gaps=gaps)
    res["attempted"] = len(losses)
    res["failed"] = sum(1 for x in losses if not math.isfinite(x))
    # no hand-written kernel runs on a sync step's path
    launches_off = sum(kernels.launch_counts().values())
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    batches = prog.pool[:tr["checked_steps"]]
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    theirs = reference(cfg, tr, batches, seed, device)
    res["reference_s"] = time.perf_counter() - t_ref
    res["details"] = compare.details(mine, theirs)
    values = {k: v for k, (v, _) in compare.gaps(mine, theirs).items()}
    values["launches_off"] = float(launches_off)
    res["values"] = values
    return res
