"""Share of the traced window, in percent, in which no operation ran on
the card (the union of the profiler's device intervals, not a sum)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
