"""``serve.paged_attn_roofline``: the share (%) of its roofline that the
paged-attention kernel (``paged_attn_kernel``) reaches in the traced
segment.  Decode attention reads far more than it computes, so the bound
is bytes: each decoded token's layer launch must read the K and V of every
position it attends to (KV heads x head size x 2 bytes each, bf16), at
the published HBM rate of one H100 SXM; the kernel's time is the
profiler's, summed over its launches in the segment (parked and padded
rows included, whose reads count for nothing here)."""

HBM_BW = 3.35e12      # bytes/s, NVIDIA H100 SXM data sheet


def token_bytes(arch: dict, positions: int) -> int:
    dh = arch["hidden_size"] // arch["num_attention_heads"]
    return arch["num_hidden_layers"] * positions * arch["num_key_value_heads"] * dh * 2 * 2


def read(trace):
    c = trace.counters
    if not c.get("decode_positions"):
        return None
    seconds = trace.kernel_us("paged_attn") / 1e6
    if seconds <= 0:
        return None
    need = sum(token_bytes(c["arch"], n) for n in c["decode_positions"])
    return 100.0 * need / HBM_BW / seconds
