"""Public Model API: init / prefill / init_cache / decode_step.

Port of ``repro.models.model`` for the attention decoder.  ``make_model(cfg)``
returns a Model of functions with the JAX package's signatures:

    init(gen)                          -> params (a ParamTree on gen.device)
    prefill(params, batch)             -> (last_logits, cache)
    init_cache(batch, max_len, device) -> zeroed cache {"k", "v"[, "mamba"]}
    decode_step(params, tokens, cache, cur_len) -> (logits, cache)

``params`` is an ``nn.Module`` whose nested parameters keep the JAX pytree's
names: ``params["blocks"][l]["attn"]["wq"]`` is layer l's slice of the JAX
package's stacked ``params["blocks"]["attn"]["wq"]``, a ``(d_in, d_out)``
matrix applied as ``x @ W``; ``params["head"]`` holds ``embed``,
``lm_head`` and ``out_norm``; hymba's meta tokens are ``params["meta"]``.
The JAX layer ``scan`` is a Python loop.

The attention decoder and the hymba hybrid are ported, with every FFN (MoE
too).  Decode writes the new token's KV into the cache in place and returns
a cache whose ``"k"``/``"v"`` are those same tensors; hymba's position-free
Mamba state (``cache["mamba"]``, ``{"h", "conv"}`` per layer) comes back as
new tensors, so that a caller keeps or drops each row's advance (the serving
engine's freeze).  Hymba prepends its meta tokens in ``prefill``, so its KV
holds ``meta_tokens`` positions before the prompt, and ``decode_step`` adds
them to ``cur_len``.  Training (``loss``) and the JAX package's xLSTM and
encoder-decoder families are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import rope_positions
from repro_torch.models.layers import COMPUTE_DTYPE, _normal, embed_init, embed_tokens


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable


class ParamTree(nn.Module):
    """Nested parameters read as ``p["attn"]["wq"]``, like the JAX package's
    dict pytrees.  Dicts become sub-trees, lists ``nn.ModuleList``s, tensors
    frozen ``nn.Parameter``s (the port has no training yet)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules


def _unsupported(cfg: ArchConfig) -> str | None:
    if cfg.enc_dec:
        return "encoder-decoder"
    if cfg.mixer not in ("attn", "hymba"):
        return f"mixer={cfg.mixer!r}"
    return None


def make_model(cfg: ArchConfig) -> Model:
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} is not yet ported")
    return _make_decoder(cfg)


def cache_batch_axes(cfg: ArchConfig) -> dict:
    """Each cache leaf's batch axis (the axis a per-row mask broadcasts
    along), in the structure of ``init_cache``: every leaf leads with
    layers, so axis 1."""
    what = _unsupported(cfg)
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} is not yet ported")
    axes = {"k": 1, "v": 1}
    if cfg.mixer == "hymba":
        axes["mamba"] = {"h": 1, "conv": 1}
    return axes


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _head_init(cfg: ArchConfig, gen: torch.Generator) -> dict:
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model)
    p["out_norm"] = tfm._norm_init(cfg, gen.device)
    return p


def _logits_fn(cfg: ArchConfig, params):
    w = params["head"]["embed"] if cfg.tie_embeddings else params["head"]["lm_head"]
    return lambda hc: (hc @ w.T).float()


def _embed(cfg: ArchConfig, params, tokens):
    h = embed_tokens(params["head"]["embed"], tokens)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE)
    return h


def _final(cfg: ArchConfig, params, h):
    return tfm._norm(cfg, params["head"]["out_norm"], h)


# ---------------------------------------------------------------------------
# decoder-only stacks (attention blocks and hymba blocks)
# ---------------------------------------------------------------------------

def _make_decoder(cfg: ArchConfig) -> Model:
    windows = cfg.windows()
    thetas = cfg.thetas()
    is_hymba = cfg.mixer == "hymba"
    meta = cfg.meta_tokens

    def init(gen: torch.Generator) -> ParamTree:
        block_init = tfm.hymba_block_init if is_hymba else tfm.attn_block_init
        params = {"blocks": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
                  "head": _head_init(cfg, gen)}
        if meta:
            params["meta"] = (_normal(gen, (meta, cfg.d_model)) * 0.02).to(COMPUTE_DTYPE)
        return ParamTree(params)

    def prefill(params, batch):
        """Returns (last-position logits (B, V) f32, cache at cur_len = S;
        hymba's KV holds the meta tokens' positions before the prompt, and
        its cache the Mamba state after the sequence)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = _embed(cfg, params, tokens)
        if meta:
            h = torch.cat([params["meta"][None].expand(b, meta, cfg.d_model), h], dim=1)
            s += meta
        positions = batch.get("positions") if cfg.rope_kind == "mrope" else None
        if positions is None:            # M-RoPE's (B, 3, S) streams may be given
            positions = rope_positions(torch.arange(s, device=h.device).expand(b, s),
                                       cfg.rope_kind)
        ks, vs, ms = [], [], []
        for p_l, w_l, t_l in zip(params["blocks"], windows, thetas):
            if is_hymba:
                h, (k, v), mst = tfm.hymba_block_apply(cfg, p_l, h, positions, w_l, t_l)
                ms.append(mst)
            else:
                h, (k, v) = tfm.attn_block_apply(cfg, p_l, h, positions, w_l, t_l)
            ks.append(k)
            vs.append(v)
        h = _final(cfg, params, h)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if is_hymba:
            cache["mamba"] = {n: torch.stack([m[n] for m in ms]) for n in ("h", "conv")}
        return _logits_fn(cfg, params)(h[:, -1]), cache

    def init_cache(batch_size: int, max_len: int, device="cuda") -> dict:
        shape = (cfg.n_layers, batch_size, max_len + meta, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                 "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
        if is_hymba:
            lb = (cfg.n_layers, batch_size)
            cache["mamba"] = {
                "h": torch.zeros((*lb, cfg.d_model, cfg.ssm_state), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((*lb, 3, cfg.d_model), dtype=COMPUTE_DTYPE,
                                    device=device)}
        return cache

    def decode_step(params, tokens, cache, cur_len):
        """tokens (B,1); cur_len counts the real tokens (an int, lockstep, or
        a (B,) tensor, in-flight: every row at its own length); the meta
        offset is added here.  Row outputs are independent of which other
        rows share the launch."""
        h = _embed(cfg, params, tokens)
        pos = cur_len + meta
        hs, convs = [], []
        for l, (p_l, w_l, t_l) in enumerate(zip(params["blocks"], windows, thetas)):
            if is_hymba:
                mst = {n: cache["mamba"][n][l] for n in ("h", "conv")}
                h, _, _, mst = tfm.hymba_block_decode(cfg, p_l, h, cache["k"][l],
                                                      cache["v"][l], mst, pos, w_l, t_l)
                hs.append(mst["h"])
                convs.append(mst["conv"])
            else:
                h, _, _ = tfm.attn_block_decode(cfg, p_l, h, cache["k"][l],
                                                cache["v"][l], pos, w_l, t_l)
        h = _final(cfg, params, h)
        if is_hymba:
            cache = {"k": cache["k"], "v": cache["v"],
                     "mamba": {"h": torch.stack(hs), "conv": torch.stack(convs)}}
        return _logits_fn(cfg, params)(h[:, -1]), cache

    return Model(cfg, init, prefill, init_cache, decode_step)
