"""Public Model API: init / loss / prefill / init_cache / decode_step per
architecture.

Port of ``repro.models.model``.  ``make_model(cfg)`` returns a Model of
functions with the JAX package's signatures:

    init(gen)                          -> params (a ParamTree on gen.device)
    loss(params, batch)                -> (total, metrics)
    forward(params, batch)             -> (final-normed h (B, S, D), MoE aux sums)
    prefill(params, batch)             -> (last_logits, cache)
    init_cache(batch, max_len, device) -> zeroed cache
    decode_step(params, tokens, cache, cur_len) -> (logits, cache)

and, for the encoder-decoder, ``encode(params, frames)``.

``params`` is an ``nn.Module`` whose nested parameters keep the JAX pytree's
names: ``params["blocks"][l]["attn"]["wq"]`` is layer l's slice of the JAX
package's stacked ``params["blocks"]["attn"]["wq"]``, a ``(d_in, d_out)``
matrix applied as ``x @ W``; ``params["head"]`` holds ``embed``,
``lm_head`` and ``out_norm``; hymba's meta tokens are ``params["meta"]``.
An xLSTM model's ``params["blocks"][g]`` is group g, its mLSTM blocks
``["mlstm"][j]``; Whisper's are ``params["enc"][l]``, ``params["dec"][l]``
and ``params["enc_norm"]``.  The JAX layer ``scan`` is a Python loop.

Every family of the JAX package is ported: the attention decoder (every
FFN, MoE too), the hymba hybrid, xLSTM and the Whisper encoder-decoder.

Training: ``loss`` is the JAX ``loss``: the forward (batch ``{"tokens",
"labels"}``, Whisper's ``"frames"`` too, M-RoPE's ``"positions"``
(B, 3, S) when given), the chunked cross-entropy, and the MoE aux losses
summed over layers, averaged, and added as ``ce + 0.01 lb + 0.001 z``
(``_moe_metrics``); metrics ``{"lb_loss", "z_loss", "drop_frac",
"ce_loss"}`` for every family.  Autograd takes the backward; the
parameters must require grad (``ParamTree`` freezes them by default, so
that serving records no graph).  ``cfg.remat`` checkpoints each layer (an
xLSTM group, a Whisper decoder block) as ``_maybe_remat`` does: ``"none"``,
``"full"`` (everything recomputed in backward) or ``"dots"`` (the (d_in,
d_out) matmul outputs saved, the rest recomputed).

Serving: decode writes the new token's KV into the cache in place and
returns a cache whose ``"k"``/``"v"`` are those same tensors.  Recurrent
state comes back as new tensors, so that a caller keeps or drops each
row's advance (the serving engine's freeze): hymba's Mamba state
(``cache["mamba"]``, ``{"h", "conv"}`` per layer) and xLSTM's whole cache
(``cache["mlstm"]`` leaves ``(n_groups, g-1, B, ...)``, ``cache["slstm"]``
leaves ``(n_groups, B, D)``, the JAX layout; xLSTM decode is position-free
and ignores ``cur_len``).  Whisper's cache adds the cross-attention KV
``xk``/``xv`` ``(L, B, enc_len, KVH, Dh)``, written by ``prefill`` and only
read by decode; its decoder positions are sinusoids of ``cur_len`` computed
on the device.  Hymba prepends its meta tokens in ``prefill`` (and in
training), so its KV holds ``meta_tokens`` positions before the prompt, and
``decode_step`` adds them to ``cur_len``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import rope_positions
from repro_torch.models.layers import (COMPUTE_DTYPE, _normal, chunked_softmax_xent,
                                       embed_init, embed_tokens)


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable
    prefill: Callable
    init_cache: Callable
    decode_step: Callable
    encode: Callable | None = None     # the encoder-decoder's encoder
    loss: Callable | None = None
    forward: Callable | None = None


class ParamTree(nn.Module):
    """Nested parameters read as ``p["attn"]["wq"]``, like the JAX package's
    dict pytrees.  Dicts become sub-trees, lists ``nn.ModuleList``s, tensors
    ``nn.Parameter``s, frozen: serving records no autograd graph (and
    captures CUDA graphs of plain kernels).  A trainer makes them trainable
    with ``requires_grad_(True)``."""

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


# the xLSTM cache's leaves, in the JAX package's order
MLSTM_LEAVES = ("c", "n", "m", "conv")
SLSTM_LEAVES = ("c", "n", "h", "m")


def make_model(cfg: ArchConfig) -> Model:
    if cfg.enc_dec:
        return _make_encdec(cfg)
    if cfg.mixer == "xlstm":
        return _make_xlstm(cfg)
    if cfg.mixer not in ("attn", "hymba"):
        raise ValueError(f"{cfg.name}: unknown mixer {cfg.mixer!r}")
    return _make_decoder(cfg)


def cache_batch_axes(cfg: ArchConfig) -> dict:
    """Each cache leaf's batch axis (the axis a per-row mask broadcasts
    along), in the structure of ``init_cache``: the JAX package's tree.
    Most leaves lead with layers, so axis 1; xLSTM's mLSTM leaves lead with
    (n_groups, g-1), so axis 2."""
    if cfg.enc_dec:
        return {"k": 1, "v": 1, "xk": 1, "xv": 1}
    if cfg.mixer == "xlstm":
        return {"mlstm": dict.fromkeys(MLSTM_LEAVES, 2),
                "slstm": dict.fromkeys(SLSTM_LEAVES, 1)}
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


def _aux0(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "drop_frac": z}


def _moe_metrics(cfg: ArchConfig, aux: dict, loss):
    """The aux sums averaged over ``n_layers``; total = ce + 0.01 lb +
    0.001 z."""
    m = {k: v / cfg.n_layers for k, v in aux.items()}
    total = loss + 0.01 * m["lb_loss"] + 0.001 * m["z_loss"]
    m["ce_loss"] = loss
    return total, m


def _make_loss(cfg: ArchConfig, forward):
    def loss(params, batch):
        """(total, metrics) of a batch (``_moe_metrics``)."""
        h, aux = forward(params, batch)
        ce = chunked_softmax_xent(_logits_fn(cfg, params), h, batch["labels"],
                                  cfg.loss_chunk)
        return _moe_metrics(cfg, aux, ce)
    return loss


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of plain matmuls (``x @ W``: ``aten.mm``), recompute everything else;
    batched matmuls (attention scores, expert FFNs) are recomputed, as JAX's
    ``dots_with_no_batch_dims_saveable`` does."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ArchConfig, body):
    """``body`` with its activations checkpointed per ``cfg.remat`` when
    grad is on (each call recomputed in backward); without grad, ``body``."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              _save_dots)}
    else:
        raise ValueError(f"{cfg.name}: remat={cfg.remat!r}; expected none, dots or full")

    def wrapped(*args):
        if torch.is_grad_enabled():
            return checkpoint(body, *args, use_reentrant=False, **kw)
        return body(*args)
    return wrapped


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

    def embed_input(params, batch):
        """(h (B, meta + S, D), positions): hymba's meta tokens first; M-RoPE's
        (B, 3, S) streams from the batch when it has them."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        h = _embed(cfg, params, tokens)
        if meta:
            h = torch.cat([params["meta"][None].expand(b, meta, cfg.d_model), h], dim=1)
            s += meta
        positions = batch.get("positions") if cfg.rope_kind == "mrope" else None
        if positions is None:
            positions = rope_positions(torch.arange(s, device=h.device).expand(b, s),
                                       cfg.rope_kind)
        return h, positions

    def block(p_l, h, aux, positions, w_l, t_l):
        if is_hymba:
            return tfm.hymba_block_apply(cfg, p_l, h, positions, w_l, t_l)[0], aux
        aux = dict(aux)
        return tfm.attn_block_apply(cfg, p_l, h, positions, w_l, t_l, aux)[0], aux

    body = _maybe_remat(cfg, block)

    def forward(params, batch):
        """The training forward: (the final-normed h (B, S, D) of the
        tokens, meta positions dropped; the MoE aux sums over layers)."""
        h, positions = embed_input(params, batch)
        aux = _aux0(h.device)
        for p_l, w_l, t_l in zip(params["blocks"], windows, thetas):
            h, aux = body(p_l, h, aux, positions, w_l, t_l)
        return _final(cfg, params, h[:, meta:]), aux

    def prefill(params, batch):
        """Returns (last-position logits (B, V) f32, cache at cur_len = S;
        hymba's KV holds the meta tokens' positions before the prompt, and
        its cache the Mamba state after the sequence)."""
        h, positions = embed_input(params, batch)
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

    return Model(cfg, init, prefill, init_cache, decode_step,
                 loss=_make_loss(cfg, forward), forward=forward)


# ---------------------------------------------------------------------------
# xLSTM (groups of g-1 mLSTM blocks and one sLSTM block)
# ---------------------------------------------------------------------------

def _make_xlstm(cfg: ArchConfig) -> Model:
    g = cfg.scan_group
    n_groups = cfg.n_layers // g
    if n_groups * g != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {g}")
    d, h = cfg.d_model, cfg.n_heads
    di = int(d * cfg.mlstm_proj_factor)
    dh = di // h

    def init(gen: torch.Generator) -> ParamTree:
        return ParamTree({"blocks": [tfm.xlstm_group_init(gen, cfg) for _ in range(n_groups)],
                          "head": _head_init(cfg, gen)})

    def cache_of(states):
        """Every group's state (``xlstm_group_apply``'s layout) as the cache:
        one stack per leaf."""
        return {"mlstm": {n: torch.stack([st[n] for grp in states for st in grp["mlstm"]]
                                         ).unflatten(0, (n_groups, g - 1))
                          for n in MLSTM_LEAVES},
                "slstm": {n: torch.stack([grp["slstm"][n] for grp in states])
                          for n in SLSTM_LEAVES}}

    def run(params, h, step):
        states = []
        for gi, p_g in enumerate(params["blocks"]):
            h, st = step(gi, p_g, h)
            states.append(st)
        return _logits_fn(cfg, params)(_final(cfg, params, h)[:, -1]), cache_of(states)

    body = _maybe_remat(cfg, lambda p_g, h: tfm.xlstm_group_apply(cfg, p_g, h)[0])

    def forward(params, batch):
        """The training forward: (the final-normed h, zero aux sums)."""
        h = _embed(cfg, params, batch["tokens"])
        for p_g in params["blocks"]:
            h = body(p_g, h)
        return _final(cfg, params, h), _aux0(h.device)

    def prefill(params, batch):
        """Returns (last-position logits, the recurrent state after the
        prompt as the cache)."""
        return run(params, _embed(cfg, params, batch["tokens"]),
                   lambda gi, p_g, h: tfm.xlstm_group_apply(cfg, p_g, h))

    def init_cache(batch_size: int, max_len: int, device="cuda") -> dict:
        gb = (n_groups, g - 1, batch_size)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"mlstm": {"c": zeros((*gb, h, dh, dh)), "n": zeros((*gb, h, dh)),
                          "m": zeros((*gb, h)), "conv": zeros((*gb, 3, di), COMPUTE_DTYPE)},
                "slstm": {"c": zeros((n_groups, batch_size, d)),
                          "n": zeros((n_groups, batch_size, d)) + 1e-6,
                          "h": zeros((n_groups, batch_size, d)),
                          "m": zeros((n_groups, batch_size, d))}}

    def decode_step(params, tokens, cache, cur_len):
        """tokens (B, 1).  Position-free: ``cur_len`` is not read.  Returns
        (logits, a new cache of the whole recurrent state)."""
        def step(gi, p_g, h):
            st = {part: {n: x[gi] for n, x in cache[part].items()}
                  for part in ("mlstm", "slstm")}
            return tfm.xlstm_group_decode(cfg, p_g, h, st)

        return run(params, _embed(cfg, params, tokens), step)

    return Model(cfg, init, prefill, init_cache, decode_step,
                 loss=_make_loss(cfg, forward), forward=forward)


# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder
# ---------------------------------------------------------------------------

def _make_encdec(cfg: ArchConfig) -> Model:
    d = cfg.d_model

    def init(gen: torch.Generator) -> ParamTree:
        return ParamTree({
            "enc": [tfm.enc_block_init(gen, cfg) for _ in range(cfg.n_enc_layers)],
            "enc_norm": tfm._norm_init(cfg, gen.device),
            "dec": [tfm.dec_block_init(gen, cfg) for _ in range(cfg.n_layers)],
            "head": _head_init(cfg, gen),
        })

    def encode(params, frames):
        """frames (B, Senc, D) -> the encoder's output (B, Senc, D) bf16."""
        h = frames.to(COMPUTE_DTYPE) + tfm.sinusoid_positions(frames.shape[1], d,
                                                             device=frames.device)
        for p_l in params["enc"]:
            h = tfm.enc_block_apply(cfg, p_l, h, None)
        return tfm._norm(cfg, params["enc_norm"], h)

    def dec_block(p_l, h, enc_h):
        ek, ev = tfm.cross_kv(cfg, p_l["cross_attn"], enc_h)
        return tfm.dec_block_apply(cfg, p_l, h, None, ek, ev)[0]

    body = _maybe_remat(cfg, dec_block)

    def forward(params, batch):
        """The training forward: (the decoder's final-normed h, zero aux
        sums).  The encoder runs without remat, as in JAX."""
        enc_h = encode(params, batch["frames"])
        tokens = batch["tokens"]
        h = _embed(cfg, params, tokens) + tfm.sinusoid_positions(tokens.shape[1], d,
                                                                 device=tokens.device)
        for p_l in params["dec"]:
            h = body(p_l, h, enc_h)
        return _final(cfg, params, h), _aux0(h.device)

    def prefill(params, batch):
        """batch {"tokens" (B, S), "frames" (B, enc_len, D)}.  Returns
        (last-position logits, cache {"k", "v"} over the S tokens and the
        cross-attention {"xk", "xv"} over the frames)."""
        enc_h = encode(params, batch["frames"])
        tokens = batch["tokens"]
        h = _embed(cfg, params, tokens) + tfm.sinusoid_positions(tokens.shape[1], d,
                                                                 device=tokens.device)
        cache = {"k": [], "v": [], "xk": [], "xv": []}
        for p_l in params["dec"]:
            ek, ev = tfm.cross_kv(cfg, p_l["cross_attn"], enc_h)
            h, (k, v) = tfm.dec_block_apply(cfg, p_l, h, None, ek, ev)
            for name, x in zip(("k", "v", "xk", "xv"), (k, v, ek, ev)):
                cache[name].append(x)
        h = _final(cfg, params, h)
        return (_logits_fn(cfg, params)(h[:, -1]),
                {name: torch.stack(xs) for name, xs in cache.items()})

    def init_cache(batch_size: int, max_len: int, device="cuda") -> dict:
        lb = (cfg.n_layers, batch_size)
        kv = (cfg.n_kv_heads, cfg.head_dim)
        return {name: torch.zeros((*lb, n, *kv), dtype=COMPUTE_DTYPE, device=device)
                for name, n in (("k", max_len), ("v", max_len), ("xk", cfg.enc_len),
                                ("xv", cfg.enc_len))}

    def decode_step(params, tokens, cache, cur_len):
        """tokens (B, 1); cur_len an int or a (B,) tensor (each row at its
        own position).  The position's sinusoid is computed from ``cur_len``
        on its device, so a captured graph reads it at replay."""
        h = _embed(cfg, params, tokens) + _sinusoid_at(cur_len, d, tokens.device)
        for l, p_l in enumerate(params["dec"]):
            h, _, _ = tfm.dec_block_decode(cfg, p_l, h, cache["k"][l], cache["v"][l],
                                           cache["xk"][l], cache["xv"][l], cur_len)
        h = _final(cfg, params, h)
        return _logits_fn(cfg, params)(h[:, -1]), cache

    return Model(cfg, init, prefill, init_cache, decode_step, encode,
                 loss=_make_loss(cfg, forward), forward=forward)


def _sinusoid_at(pos, d: int, device="cpu") -> torch.Tensor:
    """The encoding at ``pos``: an int -> (1, 1, d), a (B,) tensor -> (B, 1,
    d) (each row at its own position)."""
    return tfm.sinusoid(torch.as_tensor(pos, device=device).reshape(-1), d)[:, None, :]
