"""``serve.decode_mfu``: the whole decode step's share (%) of the card's
bf16 peak in the traced segment: the FLOPs of the tokens decoded in it,
over the segment's length, over 989 TFLOP/s (NVIDIA H100 SXM, dense bf16).

A decoded token costs two FLOPs per weight of every matrix it passes
(the attention projections, the FFN and the output head over the whole
vocabulary) and, in each layer, 4 x positions x heads x head size for the
attention scores and the weighted sum over the positions it attends to.
"""

BF16_PEAK = 989e12    # FLOP/s, NVIDIA H100 SXM data sheet, dense


def token_flops(arch: dict, positions: int) -> int:
    d, ff, v = arch["hidden_size"], arch["intermediate_size"], arch["vocab_size"]
    h = arch["num_attention_heads"]
    dh = d // h
    kv = arch["num_key_value_heads"] * dh
    per_layer = 2 * (d * h * dh + 2 * d * kv + h * dh * d + 3 * d * ff) + 4 * positions * h * dh
    return arch["num_hidden_layers"] * per_layer + 2 * d * v


def read(trace):
    c = trace.counters
    if not c.get("decode_positions") or trace.window_s <= 0:
        return None
    flops = sum(token_flops(c["arch"], n) for n in c["decode_positions"])
    return 100.0 * flops / trace.window_s / BF16_PEAK
