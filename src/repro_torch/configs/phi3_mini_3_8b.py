"""Phi-3-mini-3.8B [arXiv:2404.14219]: dense, RoPE + SwiGLU, MHA (kv=32).

A copy of ``repro.configs.phi3_mini_3_8b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    ffn="swiglu",
    supports_long=False,
    long_skip_reason="full quadratic attention in every layer",
)

SMOKE = ArchConfig(
    name="phi3-mini-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    ffn="swiglu",
    attn_chunk=32,
    loss_chunk=32,
)
