"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 5:1 local:global interleave.

26L, d_model 1152, 4 heads (MQA kv=1, head_dim 256), d_ff 6912, vocab
262144.  Local layers use a 512-token sliding window with rope theta 10k;
every 6th layer is global with theta 1M.  Tied embeddings, embedding scaled
by sqrt(d), QK-norm.  Global layers are full attention -> skip long_500k.

A copy of ``repro.configs.gemma3_1b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    window_pattern=(512, 512, 512, 512, 512, 0),
    theta_pattern=(1e4, 1e4, 1e4, 1e4, 1e4, 1e6),
    ffn="swiglu",
    supports_long=False,
    long_skip_reason="every 6th layer is global full attention",
)

SMOKE = ArchConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=1,
    d_head=32,
    d_ff=192,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    window_pattern=(16, 16, 0),
    theta_pattern=(1e4, 1e4, 1e6),
    ffn="swiglu",
    attn_chunk=32,
    loss_chunk=32,
)
