"""Plain float32 forward of a Command R decoder, for the serve cell's check.

Command R's block (Cohere, hf:CohereForAI/c4ai-command-r-08-2024,
``modeling_cohere``): one LayerNorm ``x = LN(h)`` feeds attention and
the SwiGLU FFN side by side, ``h + attn(x) + ffn(x)`` (the parallel
block); attention is grouped-query with rotary embeddings on interleaved
(even, odd) pairs, ``theta ** (-2i / Dh)``, softmax of ``q·k / sqrt(Dh)``
over the causal past; a final LayerNorm, and the logits are ``x @ E^T``
with the input embedding ``E`` (tied) or an output head.  The weights are
those the benchmark made and handed to the program too, ``(d_in, d_out)``
matrices applied as ``x @ W``; LayerNorms have a scale and a bias.

Everything runs in float32 with TF32 off, one layer at a time (each
layer's weights widened to f32 only while it runs), the dense parts over
all the sequences' tokens at once and attention sequence by sequence, so
that it fits beside the bf16 weights.  ``fp8=True`` is the control: every
weight and every activation entering a matrix product rounded to
float8 e4m3 (per-tensor scale for weights, per-row for activations) first.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded through float8 e4m3 at a scale that maps its largest
    magnitude (per row with ``dim``) onto the format's largest value."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = FP8_MAX / amax.clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _layernorm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def _rope(x, pos, theta):
    """x (T, heads, Dh); rotate each (even, odd) pair by pos·theta^(-2i/Dh)."""
    dh = x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = (pos.to(torch.float64)[:, None] * inv).to(torch.float32)[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], -1).flatten(-2)


def logits_at(weights: dict, arch: dict, seqs: list[torch.Tensor],
              at: list[torch.Tensor], fp8: bool = False) -> list[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (1-D int64 on the weights'
    device), the float32 logits at positions ``at[i]``: (len(at[i]), V)."""
    d, h_n, kv_n = arch["hidden_size"], arch["num_attention_heads"], arch["num_key_value_heads"]
    dh, eps, theta = d // h_n, arch["layer_norm_eps"], float(arch["rope_theta"])
    lens = [len(s) for s in seqs]
    offs = torch.tensor([0] + lens).cumsum(0).tolist()
    tokens = torch.cat(seqs)
    pos = torch.cat([torch.arange(n, device=tokens.device) for n in lens])

    def mm(x, w):
        w = w.float()
        if fp8:
            return _fp8(x, dim=-1) @ _fp8(w)
        return x @ w

    with _no_tf32():
        h = weights["head"]["embed"][tokens].float()
        for blk in weights["blocks"]:
            x = _layernorm(h, blk["ln1"], eps)
            q = _rope(mm(x, blk["attn"]["wq"]).view(-1, h_n, dh), pos, theta)
            k = _rope(mm(x, blk["attn"]["wk"]).view(-1, kv_n, dh), pos, theta)
            v = mm(x, blk["attn"]["wv"]).view(-1, kv_n, dh)
            ctx = torch.empty_like(q)
            for a, b in zip(offs[:-1], offs[1:]):
                qi = q[a:b].transpose(0, 1)                               # (H, T, Dh)
                ki = k[a:b].transpose(0, 1).repeat_interleave(h_n // kv_n, 0)
                vi = v[a:b].transpose(0, 1).repeat_interleave(h_n // kv_n, 0)
                s = qi @ ki.transpose(1, 2) / dh ** 0.5
                causal = torch.ones(b - a, b - a, dtype=torch.bool, device=s.device).tril()
                s = s.masked_fill(~causal, float("-inf"))
                ctx[a:b] = (torch.softmax(s, -1) @ vi).transpose(0, 1)
            attn = mm(ctx.reshape(-1, h_n * dh), blk["attn"]["wo"])
            g = mm(x, blk["mlp"]["w_gate"])
            ffn = mm(torch.nn.functional.silu(g) * mm(x, blk["mlp"]["w_up"]),
                     blk["mlp"]["w_down"])
            h = h + attn + ffn
        x = _layernorm(h, weights["head"]["out_norm"], eps)
        head = weights["head"]["embed"] if arch["tie_word_embeddings"] else weights["head"]["lm_head"]
        out = []
        for a, want in zip(offs[:-1], at):
            rows = x[a + want]
            out.append(torch.cat([mm(rows, head[c:c + 32768].T)
                                  for c in range(0, head.shape[0], 32768)], -1))
        return out
