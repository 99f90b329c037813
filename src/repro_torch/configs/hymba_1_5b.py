"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + mamba heads.

32L, d_model 1600, 25 heads (GQA kv=5, head_dim 64), d_ff 5504, vocab 32001,
ssm_state 16, 128 learnable meta tokens.  Attention is sliding-window except
3 global layers (first / middle / last, per the paper).  Hybrid ->
long_500k runs (SSM state is O(1); windowed KV is bounded; the 3 global
layers carry the full-length KV).

A copy of ``repro.configs.hymba_1_5b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

_GLOBAL_LAYERS = (0, 15, 31)
_WINDOWS = tuple(0 if i in _GLOBAL_LAYERS else 1024 for i in range(32))

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    mixer="hymba",
    ffn="swiglu",
    ssm_state=16,
    meta_tokens=128,
    window_pattern=_WINDOWS,
    supports_long=True,
    ssm_chunk=256,
)

SMOKE = ArchConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=80,
    n_heads=5,
    n_kv_heads=5,
    d_ff=160,
    vocab_size=256,
    mixer="hymba",
    ffn="swiglu",
    ssm_state=8,
    meta_tokens=8,
    window_pattern=(0, 16),
    supports_long=True,
    ssm_chunk=16,
    attn_chunk=32,
    loss_chunk=32,
)
