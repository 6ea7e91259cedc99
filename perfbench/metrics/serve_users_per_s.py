"""serve_users_per_s: users whose ranked lists reached the host in the
window, over the window's seconds (host clock; every call counts)."""


def read(ctx):
    w = ctx.window
    return w.rows / w.seconds if w.seconds > 0 else None
