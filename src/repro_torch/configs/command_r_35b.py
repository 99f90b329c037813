"""Command-R-35B [hf:CohereForAI/c4ai-command-r-v01]: dense GQA, no-bias,
parallel attention+FFN residual block, LayerNorm.

A copy of ``repro.configs.command_r_35b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8e6,
    ffn="swiglu",
    parallel_block=True,
    norm="ln",
    supports_long=False,
    long_skip_reason="full quadratic attention in every layer",
)

SMOKE = ArchConfig(
    name="command-r-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    ffn="swiglu",
    parallel_block=True,
    norm="ln",
    attn_chunk=32,
    loss_chunk=32,
)
