"""``cache.kernels_per_batch``: device kernels per batch in the traced
segment (copies and sets left out), from the profiler: the launches of the
one-pass prologue, kernel and epilogue that one ``access`` issues."""


def read(trace):
    n = trace.counters.get("batches")
    if not n:
        return None
    kernels = sum(1 for op in trace.ops if not op.name.startswith(("Memcpy", "Memset")))
    return kernels / n if kernels else None
