"""setup_s: seconds from the process's start of the harness to the first
timed call — the inputs drawn, the system built, every shape of the cell
warmed (and, on a checkout's first run, the kernels compiled)."""


def read(ctx):
    return ctx.setup_s
