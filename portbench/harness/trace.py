"""The traced window: ``torch.profiler`` over a few whole steps, device
activity and host operators, read from the profiler's raw events.

``Trace`` holds the device spans (kernels, copies and fills) as
``(name, start us, end us)`` in order of start, the host operators that
were running, the window's host-clock seconds and its step count; the
per-layer readers take their numbers from it."""

from __future__ import annotations

import bisect
import time

import torch


def _events(prof):
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.duration_ns() <= 0:
            continue
        span = (e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    return sorted(dev, key=lambda s: s[1]), sorted(host, key=lambda s: s[1])


class Trace:
    def __init__(self, device, host, window_s, steps):
        self.device, self.host = device, host
        self.window_s, self.steps = window_s, steps

    def busy(self):
        """[(start, end)] of the union of the device spans (us)."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy()) / 1e6

    def by_name(self):
        tot = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return tot

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        between device activity summed by the innermost host operator
        running where each gap starts: [[name, seconds], ...] each."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        starts = [s for _, s, _ in self.host]
        gaps = {}
        busy = self.busy()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            i = bisect.bisect_right(starts, e0)
            label = "host"
            for name, s, e in reversed(self.host[max(0, i - 512):i]):
                if e >= e0:
                    label = name
                    break
            gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n[:120], t] for n, t in idle]}


def traced(run_steps, steps, host=False):
    """``run_steps(steps)`` (dispatches the steps and reads each loss)
    under the profiler, recording device activity and, with ``host``, the
    host's operators too (which slows the host): a :class:`Trace`."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    return Trace(dev, host, window, steps)
