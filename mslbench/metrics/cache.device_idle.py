"""``cache.device_idle``: the share of the traced segment in which no
operation ran on the device, 1 - busy / window, from the profiler."""


def read(trace):
    if "distinct_sets" not in trace.counters or trace.busy_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
