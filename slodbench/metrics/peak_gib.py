"""peak_gib: ``torch.cuda.max_memory_allocated()`` over set-up and the
window, never reset, in GiB (None off the card)."""


def read(ctx):
    return ctx["peak_bytes"] / 2.0 ** 30 if ctx["peak_bytes"] else None
