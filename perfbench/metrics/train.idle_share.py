"""train.idle_share: the share of the traced window in which no operation
ran on the device, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
