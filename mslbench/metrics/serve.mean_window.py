"""``serve.mean_window``: engine ticks per megastep window over the window,
from the difference of ``ServeEngine.stats()`` across it (``mean_window``
times ``megastep_windows``, over the windows run)."""


def read(trace):
    c = trace.counters
    if not c.get("windows"):
        return None
    return c["window_ticks"] / c["windows"]
