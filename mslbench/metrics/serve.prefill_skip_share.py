"""``serve.prefill_skip_share``: the share of the prompt tokens of the
requests admitted in the window that the prefix cache served, sum of
``Request.prefill_skipped`` over the sum of skipped and computed."""


def read(trace):
    c = trace.counters
    if "prefill_skipped" not in c:
        return None
    total = c["prefill_skipped"] + c["prefill_computed"]
    return c["prefill_skipped"] / total if total else None
