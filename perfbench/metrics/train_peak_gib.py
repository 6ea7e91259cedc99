"""train_peak_gib: ``torch.cuda.max_memory_allocated()`` from the start of
set-up to the end of the window, in GiB (read by the harness from the
allocator; the largest over the ranks of the run)."""


def read(ctx):
    return ctx.memory_peak_bytes / 2**30 if ctx.memory_peak_bytes else None
