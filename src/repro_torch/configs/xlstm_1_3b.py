"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks, 7:1 ratio.

48 blocks, d_model 2048, 4 heads.  d_ff=0 per the assignment: xLSTM blocks
carry their own projections (mLSTM pf=2 up/gate/down; the sLSTM block is
followed by a pf=4/3 GeLU MLP per the paper).  Sub-quadratic (recurrent
state), so long_500k runs.

A copy of ``repro.configs.xlstm_1_3b``: the published widths and depth
(``CONFIG``) and the reduced same-family config the CPU tests use
(``SMOKE``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mixer="xlstm",
    ffn="none",
    scan_group=8,              # 7 mLSTM + 1 sLSTM per super-block
    mlstm_proj_factor=2.0,
    supports_long=True,
    ssm_chunk=256,
)

SMOKE = ArchConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    mixer="xlstm",
    ffn="none",
    scan_group=4,
    mlstm_proj_factor=2.0,
    supports_long=True,
    ssm_chunk=16,
    attn_chunk=32,
    loss_chunk=32,
)
