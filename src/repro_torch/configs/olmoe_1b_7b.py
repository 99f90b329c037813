"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts, top-8, QK-norm.

16L, d_model 2048, 16 heads, expert d_ff 1024 (SwiGLU), vocab 50304.
1B active / 7B total.

A copy of ``repro.configs.olmoe_1b_7b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    ffn="moe",
    n_experts=64,
    moe_top_k=8,
    capacity_factor=1.25,
    moe_group_chunk=32,
    supports_long=False,
    long_skip_reason="full quadratic attention in every layer",
)

SMOKE = ArchConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    qk_norm=True,
    ffn="moe",
    n_experts=8,
    moe_top_k=2,
    capacity_factor=1.5,
    moe_group_chunk=2,
    attn_chunk=32,
    loss_chunk=32,
)
