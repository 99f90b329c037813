"""ArchConfig dataclass, the shape registry, and the registry of the
architectures the port runs.

A copy of ``repro.configs.base`` (``ArchConfig``, ``ShapeSpec``, ``SHAPES``,
``get_config``): the
port keeps its own so that it imports nothing of the JAX package.  Each
ported architecture ships as ``configs/<id>.py`` defining ``CONFIG`` (the
published dims) and ``SMOKE`` (a reduced same-family config for CPU
tests).  The port runs every architecture of the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import NamedTuple

# The JAX package's architectures, in the order the port took them up.
_ARCH_IDS = ["phi3-mini-3.8b", "gemma3-1b", "starcoder2-7b", "command-r-35b",
             "qwen2-vl-72b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b",
             "xlstm-1.3b", "whisper-medium"]


class ShapeSpec(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # block structure
    mixer: str = "attn"         # attn | xlstm | hymba
    ffn: str = "swiglu"         # swiglu | gelu | moe | none
    parallel_block: bool = False
    norm: str = "rms"           # rms | ln
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False   # gemma: h *= sqrt(d)

    # attention
    rope_kind: str = "rope"     # rope | mrope | none
    rope_theta: float = 1e4
    qk_norm: bool = False
    softcap: float = 0.0
    window_pattern: tuple = (0,)        # cycled per layer; 0 = global
    theta_pattern: tuple = ()           # cycled per layer; () = rope_theta

    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_chunk: int = 2

    # ssm / recurrent
    ssm_state: int = 16
    mlstm_proj_factor: float = 2.0
    scan_group: int = 1         # sub-layers per scanned super-block (xlstm: 8)

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500

    # frontends (stubs provide embeddings directly)
    input_kind: str = "tokens"  # tokens | frames
    meta_tokens: int = 0        # hymba learnable prefix tokens

    # shape support
    supports_long: bool = False  # run long_500k?
    long_skip_reason: str = ""

    # execution tiling
    attn_chunk: int = 512
    ssm_chunk: int = 256
    loss_chunk: int = 512
    remat: str = "none"         # none | dots | full — checkpointing of scan bodies

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def windows(self):
        pat = self.window_pattern or (0,)
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def thetas(self):
        pat = self.theta_pattern or (self.rope_theta,)
        return tuple(float(pat[i % len(pat)]) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Parameters the port's model builds: embedding, blocks and norms.
        The JAX package's analytic count leaves the norms out and
        approximates the Mamba branch; here every leaf counts: LayerNorm has
        a scale and a bias, RMSNorm a scale; a parallel block has no
        ``ln2``; QK-norm adds 2 * Dh per layer; an MoE FFN is E experts'
        SwiGLU plus the (d, E) router; a hymba block adds the Mamba branch
        (d_inner = d, a 4-tap conv) and the two fuse vectors; meta tokens add
        meta_tokens * d.  xLSTM counts its groups of (g-1) mLSTM blocks and
        one sLSTM block with its GeLU MLP; Whisper its encoder blocks, the
        decoder blocks' self- and cross-attention and the encoder's norm."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        dh, h, kvh = self.head_dim, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        norm = d * (2 if self.norm == "ln" else 1)
        if self.mixer == "xlstm":
            di, g = int(d * self.mlstm_proj_factor), self.scan_group
            # ln; w_up, w_down; conv_w, skip_scale; wq/wk/wv; w_if, if_bias
            per_m = norm + 3 * d * di + 5 * di + 3 * di * di + 2 * h * di + 2 * h
            # ln, ln_ffn; w_gates, r_gates, gate_bias; the GeLU MLP
            per_s = (2 * norm + 4 * d * d + 4 * h * (d // h) ** 2 + 4 * d
                     + 2 * d * xlstm_ffn_dim(self))
            return emb + self.n_layers // g * ((g - 1) * per_m + per_s) + norm
        att = d * (h * dh) * 2 + d * (kvh * dh) * 2
        ffn = {"swiglu": 3 * d * f, "gelu": 2 * d * f,
               "moe": self.n_experts * (3 * d * f + d)}.get(self.ffn, 0)
        if self.enc_dec:
            enc = self.n_enc_layers * (att + ffn + 2 * norm) + norm
            return emb + enc + self.n_layers * (2 * att + ffn + 3 * norm) + norm
        norms = norm * (1 if self.parallel_block or self.ffn == "none" else 2)
        norms += 2 * dh if self.qk_norm else 0
        per = att + ffn + norms
        if self.mixer == "hymba":
            n = self.ssm_state
            # w_in, w_dt, w_out; conv_w, dt_bias, d_skip; w_bc, a_log; fuse_a/m
            per += 4 * d * d + 6 * d + 3 * d * n + 2 * d
        return emb + self.n_layers * per + norm + self.meta_tokens * d


def xlstm_ffn_dim(cfg: ArchConfig) -> int:
    """The sLSTM block's post-MLP width (pf = 4/3), rounded up to a multiple
    of 128 (16 below 1024), as the JAX package rounds it."""
    raw = int(cfg.d_model * 4 / 3)
    m = 128 if raw >= 1024 else 16
    return (raw + m - 1) // m * m


_MODULE_FOR = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
               for a in _ARCH_IDS}


def list_archs():
    """The architectures the port runs."""
    return list(_ARCH_IDS)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_IDS)}")
    mod = importlib.import_module(_MODULE_FOR[name])
    return mod.SMOKE if smoke else mod.CONFIG
