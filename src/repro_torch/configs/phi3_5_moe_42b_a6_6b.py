"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
16 experts top-2, GQA kv=8.

A copy of ``repro.configs.phi3_5_moe_42b_a6_6b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    ffn="moe",
    n_experts=16,
    moe_top_k=2,
    capacity_factor=1.25,
    moe_group_chunk=32,
    supports_long=False,
    long_skip_reason="full quadratic attention in every layer",
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=48,
    vocab_size=256,
    ffn="moe",
    n_experts=4,
    moe_top_k=2,
    capacity_factor=1.5,
    moe_group_chunk=2,
    attn_chunk=32,
    loss_chunk=32,
)
