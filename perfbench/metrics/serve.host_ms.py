"""serve.host_ms: mean host milliseconds from the call into ``serve_batch``
to its return (the launches enqueued, before the copy to the host), over
the traced window's calls (under the profiler)."""


def read(ctx):
    calls = ctx.window.calls
    if ctx.trace is None or not calls:
        return None
    return 1e3 * sum(c.t_return - c.t_call for c in calls) / len(calls)
