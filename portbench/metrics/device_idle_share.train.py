"""device_idle_share.train: 1 - (the union of device activity) / (the
traced window's host-clock seconds), in %."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
