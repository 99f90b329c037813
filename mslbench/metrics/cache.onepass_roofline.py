"""``cache.onepass_roofline``: the share (%) of its roofline that
``msl_onepass_kernel`` reaches in the traced segment.

The kernel does integer work whose peak rate NVIDIA does not publish, so
it is bounded by bytes alone: what a batch needs to move is each distinct
set's row read once and written once, the queries' keys and values read,
and each query's results written (hit, lane, value, evicted record), at
the published HBM rate of one H100 SXM.  The kernel's time is the
profiler's, summed over its launches in the segment.
"""

HBM_BW = 3.35e12      # bytes/s, NVIDIA H100 SXM data sheet


def batch_bytes(batch: int, distinct_sets: int, assoc: int, planes: int,
                key_planes: int, value_planes: int) -> int:
    rows = 2 * distinct_sets * assoc * planes * 4
    queries = batch * (key_planes + value_planes) * 4
    results = batch * (2 + value_planes + planes) * 4
    return rows + queries + results


def read(trace):
    c = trace.counters
    if "distinct_sets" not in c:
        return None
    seconds = trace.kernel_us("msl_onepass") / 1e6
    if seconds <= 0:
        return None
    need = sum(batch_bytes(c["batch"], d, c["assoc"], c["planes"], c["key_planes"],
                           c["value_planes"]) for d in c["distinct_sets"])
    return 100.0 * need / HBM_BW / seconds
