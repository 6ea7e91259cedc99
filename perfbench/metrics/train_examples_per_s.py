"""train_examples_per_s: examples of every step made in the window, over
the window's seconds, which end when the card has finished the last step
(host clock)."""


def read(ctx):
    w = ctx.window
    return w.rows / w.seconds if w.seconds > 0 else None
