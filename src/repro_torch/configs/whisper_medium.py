"""Whisper-medium [arXiv:2212.04356]: encoder-decoder, conv frontend STUB.

24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 4096, vocab
51865.  The conv1d audio frontend is stubbed per the assignment: requests
carry precomputed frame embeddings (1500, 1024).  Decoder positions are
sinusoidal (the real model's learned table stops at 448; sinusoids let the
32k decode *shapes* lower — noted deviation).

A copy of ``repro.configs.whisper_medium``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    rope_kind="none",
    ffn="gelu",
    norm="ln",
    enc_dec=True,
    n_enc_layers=24,
    enc_len=1500,
    input_kind="frames",
    supports_long=False,
    long_skip_reason="encoder-decoder; decoder is full attention",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    rope_kind="none",
    ffn="gelu",
    norm="ln",
    enc_dec=True,
    n_enc_layers=2,
    enc_len=30,
    input_kind="frames",
    attn_chunk=16,
    loss_chunk=32,
)
