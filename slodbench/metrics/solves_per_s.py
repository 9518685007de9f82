"""solves_per_s: solves completed in the window over the window's
seconds (the window ends when the solve running at its deadline
completes, so every solve counted lies inside it)."""


def read(ctx):
    return len(ctx["latencies"]) / ctx["window_s"]
