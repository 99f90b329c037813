"""``cache.enqueue_us_per_batch``: host microseconds the client spends in one
``MultiStepLRUCache.access`` call (the cache API and the engine's host
side: canonicalising, hashing, the one-pass prologue and epilogue being
enqueued), by the host clock around each call with no sync inside; the
mean over the window's batches before the traced segment (a profiler,
once started, slows the host's launches for the rest of the process)."""


def read(trace):
    xs = trace.counters.get("enqueue_s")
    if not xs:
        return None
    return 1e6 * sum(xs) / len(xs)
