"""StarCoder2-7B [arXiv:2402.19173]: GQA kv=4, RoPE, 4k sliding window,
GeLU FFN, LayerNorm.

A copy of ``repro.configs.starcoder2_7b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1e5,
    window_pattern=(4096,),
    ffn="gelu",
    norm="ln",
    supports_long=False,
    long_skip_reason="attention-only arch (window helps but the assignment "
                     "classes it full-attention; skipped per spec)",
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=144,
    n_heads=6,
    n_kv_heads=2,
    d_ff=288,
    vocab_size=512,
    window_pattern=(32,),
    ffn="gelu",
    norm="ln",
    attn_chunk=32,
    loss_chunk=32,
)
