"""Qwen2-VL-72B [arXiv:2409.12191]: VLM backbone with M-RoPE.

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
The vision frontend is a stub: a caller may pass the (B, 3, S) multimodal
position streams M-RoPE consumes (t/h/w) as ``batch["positions"]``; for
text the three streams coincide.  Full attention -> skip
long_500k.

A copy of ``repro.configs.qwen2_vl_72b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_kind="mrope",
    rope_theta=1e6,
    ffn="swiglu",
    supports_long=False,
    long_skip_reason="full quadratic attention in every layer",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope_kind="mrope",
    rope_theta=1e6,
    ffn="swiglu",
    attn_chunk=32,
    loss_chunk=32,
)
