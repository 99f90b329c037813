"""Shared layers: initializers, norms, RoPE, FFNs, embeddings, the loss.

Port of ``repro.models.layers`` with the JAX package's conventions:

  * weights are ``(d_in, d_out)`` and applied as ``x @ W`` (so each tensor
    compares with its JAX counterpart like for like);
  * compute dtype is bf16, with the JAX cast points: norms (RMSNorm and
    LayerNorm) take their row statistics in f32 and multiply in bf16, RoPE
    and M-RoPE rotate in f32;
  * the norms' backward is the JAX package's custom VJP (``_rms_bwd``,
    ``_ln_bwd``) as a ``torch.autograd.Function``: every (..., D) value
    stays in the activation dtype, the statistics are f32 row dots, and
    the saved residuals are ``(x, scale, inv)`` and ``(xc, scale, inv)``,
    never an f32 copy of x.  Without grad (serving) the norms run the same
    forward lines outside the Function;
  * ``chunked_softmax_xent`` recomputes each sequence chunk's logits in
    backward (``torch.utils.checkpoint``), as the JAX scan's
    ``jax.checkpoint`` does, so the (B, S, V) logits never live at once;
  * initializers draw from an explicit ``torch.Generator`` on the target
    device (normal × scale in f32, then cast), so a full-width model is
    made on the card without a host copy.  The numbers differ from
    ``jax.random``'s; tests carry the JAX parameters across instead
    (``repro_torch.core.params_from_numpy``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# activation-sharding hints
#
# The step builders on a mesh register a hint fn (launch/sharding.make_hints)
# and the model pins its activations with it at block boundaries, as the JAX
# package's pjit steps do: a DTensor is laid out again by its tag's spec.
# With no fn registered, ``hint`` is the identity.
# ---------------------------------------------------------------------------

_HINT = {"fn": None}


def set_sharding_hints(fn) -> None:
    """fn(x, tag) -> x laid out for ``tag``, or None to disable."""
    _HINT["fn"] = fn


def hint(x, tag: str):
    fn = _HINT["fn"]
    return x if fn is None else fn(x, tag)


@contextlib.contextmanager
def sharding_hints(fn):
    """``fn`` registered as the hint inside the block, the previous one
    restored on the way out (a step on a mesh never leaves its hint to a
    later step on one device)."""
    prev = _HINT["fn"]
    set_sharding_hints(fn)
    try:
        yield
    finally:
        set_sharding_hints(prev)


def from_local(x: torch.Tensor, mesh, placements, shape=None, stride=None):
    """The DTensor whose shard on this rank is ``x``, with no check and no
    communication: of global ``shape`` (default ``x``'s, for placements that
    split nothing) and ``stride`` (default contiguous)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(x.shape if shape is None else shape)
    if stride is None:
        stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x, mesh, tuple(placements), run_check=False, shape=shape,
                              stride=stride)


def pad_local(x: torch.Tensor, pad, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, pad, value=value)`` for pads of dims no mesh axis shards: a
    DTensor pads its shard and keeps its placements (a pending sum is
    reduced first).  torch 2.11's DTensor fails to plan ``pad``'s
    redistribution (an IndexError in its transform planner)."""
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, pad, value=value)
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    shape = list(x.shape)
    for i in range(len(pad) // 2):
        dim = x.dim() - 1 - i
        if any(p.is_shard(dim) for p in pl) and (pad[2 * i] or pad[2 * i + 1]):
            raise ValueError(f"pad_local: dim {dim} is sharded ({pl})")
        shape[dim] += pad[2 * i] + pad[2 * i + 1]
    return from_local(torch.nn.functional.pad(x.to_local(), pad, value=value), x.device_mesh,
                      pl, shape)


def rows_local(fn, *xs, whole=()):
    """``fn(*xs, *whole)`` for math independent per row: dim 0 of every
    tensor in ``xs`` and of every output is the batch; ``whole`` holds
    tensors every row reads (parameters).  On DTensors each rank runs ``fn``
    on its rows with every other dim whole: the rows keep the batch
    sharding of the first DTensor of ``xs`` (where it divides them), every
    other dim is gathered (a pending sum reduced first); a plain tensor
    holds every row.  A gradient of a ``whole`` tensor is a pending sum
    over the axes the rows shard.  The outputs (a tensor, or nested tuples,
    lists and dicts of them) come back as DTensors laid out as the rows.
    Regions whose heads a mesh axis does not divide (xLSTM's 4 heads over
    16 ranks) run here.  A plain call on one device."""
    first = next((x for x in xs if is_dtensor(x)), None)
    if first is None:
        return fn(*xs, *whole)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.utils._pytree import tree_map

    mesh = first.device_mesh
    rows = [Replicate()] * mesh.ndim
    n = 1
    for i, p in enumerate(first.placements):
        if p == Shard(0) and first.shape[0] % (n * mesh.size(i)) == 0:
            rows[i], n = p, n * mesh.size(i)
    rows = tuple(rows)
    everywhere = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in rows)

    def block(x, pl, grad_pl=None):
        if not isinstance(x, torch.Tensor):
            return x
        if not is_dtensor(x):
            x = from_local(x, mesh, everywhere)
        return x.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    out = fn(*(block(x, rows) for x in xs), *(block(w, everywhere, summed) for w in whole))
    return tree_map(lambda y: from_local(y.contiguous(), mesh, rows,
                                         (y.shape[0] * n, *y.shape[1:])), out)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the shard itself (a DTensor's global strides may say contiguous)
        return from_local(g.to_local().contiguous(), g.device_mesh, g.placements, g.shape,
                          g.stride())


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with a DTensor's gradient made contiguous on its way back: a
    redistributed gradient's shard may come back in a transposed layout,
    which DTensor cannot ``view`` (a reshape's backward).  A plain tensor is
    returned as it is."""
    return _ContiguousGrad.apply(x) if is_dtensor(x) else x


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (a step on a mesh)."""
    if type(x) is torch.Tensor:          # the one-device path imports nothing
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage), any other tensor itself."""
    return x.to_local() if is_dtensor(x) else x

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=PARAM_DTYPE):
    scale = (1.0 / d_in) ** 0.5
    return (_normal(gen, (d_in, d_out)) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=PARAM_DTYPE):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dots (..., D) x (..., D) -> (..., 1) in f32 (bf16 products are
    exact in f32), as the JAX ``_row_dot``."""
    return (a.float() * b.float()).sum(-1, keepdim=True)


def _needs_grad(*args) -> bool:
    """Grad is on and some tensor among ``args`` requires it: the forward
    records a graph.  Serving (frozen parameters) never does."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def _rms_inv(x, eps):
    xf = x.float()
    return torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[-1] + eps)


def _rms_out(x, scale, inv):
    return x * inv.to(x.dtype) * scale.to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """``_rms_core`` with ``_rms_fwd``/``_rms_bwd``'s arithmetic."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, scale, inv)
        return _rms_out(x, scale, inv)

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        inv_x = inv.to(x.dtype)
        gs = g * scale.to(x.dtype)
        # d(inv)/dx_j = -inv^3 x_j / d;  gx = gs * inv - x * inv^3 / d * <gs, x>
        coef = _row_dot(gs, x) * inv * inv * inv / x.shape[-1]
        gx = gs * inv_x - x * coef.to(x.dtype)
        gscale = (g * x * inv_x).float().sum(dim=tuple(range(x.dim() - 1)))
        return gx, gscale.to(scale.dtype), None


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean square, then ``x * inv * scale`` in x's dtype (the JAX
    ``_rms_core``'s cast points)."""
    scale = params["scale"]
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rms_out(x, scale, _rms_inv(x, eps))


def _ln_stats(x, eps):
    """(xc = (x - mu) * inv in x's dtype, inv (..., 1) f32), with
    ``var = max(E[x^2] - mu^2, 0)`` from f32 sums."""
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / d
    ex2 = (xf * xf).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(torch.clamp(ex2 - mu * mu, min=0.0) + eps)
    return (x - mu.to(x.dtype)) * inv.to(x.dtype), inv


def _ln_out(xc, scale, bias):
    return xc * scale.to(xc.dtype) + bias.to(xc.dtype)


class _LayerNorm(torch.autograd.Function):
    """``_ln_core`` with ``_ln_fwd``/``_ln_bwd``'s arithmetic."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xc, inv = _ln_stats(x, eps)
        ctx.save_for_backward(xc, scale, inv)
        return _ln_out(xc, scale, bias)

    @staticmethod
    def backward(ctx, g):
        xc, scale, inv = ctx.saved_tensors
        d, dt = xc.shape[-1], xc.dtype
        gs = g * scale.to(dt)
        m1 = gs.float().sum(-1, keepdim=True) / d
        m2 = _row_dot(gs, xc) / d
        gx = (gs - m1.to(dt) - xc * m2.to(dt)) * inv.to(dt)
        axes = tuple(range(xc.dim() - 1))
        return gx, (g * xc).float().sum(dim=axes), g.float().sum(dim=axes), None


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and mean square, ``var = max(E[x^2] - mu^2, 0)``, then
    ``(x - mu) * inv * scale + bias`` in x's dtype (the JAX ``_ln_core``'s
    cast points)."""
    scale, bias = params["scale"], params["bias"]
    if _needs_grad(x, scale, bias):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_out(_ln_stats(x, eps)[0], scale, bias)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) int.  Pairwise (even, odd)
    rotation in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (..., S, H, Dh); positions (..., 3, S)
    int, one stream each for the (t, h, w) sections, which are relative
    weights over the Dh/2 frequency slots.  With three equal streams it is
    ``apply_rope`` bit for bit."""
    d_half = x.shape[-1] // 2
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections[:-1]:
        acc += (d_half * s) // total
        bounds.append(acc)
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    slot = torch.arange(d_half, device=x.device)
    section_id = torch.zeros((d_half,), dtype=torch.long, device=x.device)
    for b in bounds:
        section_id += (slot >= b).long()
    ang = _mrope_pos(positions, section_id) * freqs               # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _mrope_pos(positions: torch.Tensor, section_id: torch.Tensor) -> torch.Tensor:
    """positions (..., 3, S), section_id (Dh/2,) -> (..., S, Dh/2) f32: each
    frequency slot's position stream."""
    return positions.movedim(-2, -1).to(torch.float32)[..., section_id]


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {"w_gate": dense_init(gen, d, d_ff), "w_up": dense_init(gen, d, d_ff),
            "w_down": dense_init(gen, d_ff, d)}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = g * torch.sigmoid(g) * u          # jax.nn.silu(g) * u
    return h @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {"w_up": dense_init(gen, d, d_ff), "w_down": dense_init(gen, d_ff, d)}


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(embedding):
        return _embed_local(embedding, tokens)
    return embedding[tokens.long()].to(COMPUTE_DTYPE)


def _embed_local(embedding, tokens):
    """The lookup of a DTensor table, vocab-parallel as GSPMD and Megatron
    do it: each rank looks its rows of ``tokens`` up in its own slice of the
    vocab (the table's shard over the mesh dims that split its rows; every
    other dim whole), other ids giving zero rows, and one all-reduce over
    those mesh dims sums the rows (exactly: one rank's row is nonzero).  The
    rows' activations are laid out as the tokens.  Backward: each rank's
    slice gradient is a partial sum over the mesh dims the tokens are
    sharded on.  (DTensor's own scatter-add backward of the lookup fails on
    some PyTorch versions.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = embedding.device_mesh
    rows = tokens.placements if is_dtensor(tokens) else (Replicate(),) * mesh.ndim
    vocab = tuple(not r.is_shard() and p == Shard(0)
                  for r, p in zip(rows, embedding.placements))
    want = tuple(Shard(0) if v else Replicate() for v in vocab)
    if tuple(embedding.placements) != want:
        embedding = embedding.redistribute(mesh, want)
    table = embedding.to_local(grad_placements=tuple(
        Shard(0) if v else Partial() if r.is_shard() else Replicate()
        for v, r in zip(vocab, rows)))
    ids = local(tokens).long()
    if any(vocab):
        # this rank's slice: torch.chunk of the rows, mesh dims in order
        coord, lo, n = mesh.get_coordinate(), 0, embedding.shape[0]
        for i, v in enumerate(vocab):
            if v:
                n //= mesh.size(i)
                lo += coord[i] * n
        ids = ids - lo
        mine = (ids >= 0) & (ids < table.shape[0])
        h = torch.where(mine[..., None], table[torch.where(mine, ids, 0)], 0)
    else:
        h = table[ids]
    shape = (*tokens.shape, embedding.shape[-1])
    out = from_local(h.to(COMPUTE_DTYPE), mesh,
                     tuple(Partial() if v else r for v, r in zip(vocab, rows)), shape)
    return out.redistribute(mesh, rows) if any(vocab) else out


def recompute_in_backward(fn, *args):
    """``fn(*args)``, its activations recomputed in backward
    (``jax.checkpoint``) when the call records a graph; otherwise a plain
    call, so a forward-only caller launches exactly what ``fn`` launches."""
    if _needs_grad(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _xent_sum(logits_fn, hc, yc):
    # the gather and logsumexp read whole vocab rows
    logits = hint(logits_fn(hc).float(), "loss_logits")
    gold = logits.gather(-1, yc[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_softmax_xent(logits_fn, h: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the vocab without the (B, S, V) logits at
    once.  ``logits_fn(h_chunk (B, c, D)) -> (B, c, V)``; S is cut into
    ``chunk``-position chunks, each recomputed in backward, and a remainder
    chunk when S is not a multiple (not recomputed, as in JAX).  The chunk
    sums add up in f32 in sequence order."""
    b, s, _ = h.shape
    n = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + recompute_in_backward(_xent_sum, logits_fn, h[:, sl], labels[:, sl])
    if n * chunk < s:
        total = total + _xent_sum(logits_fn, h[:, n * chunk:], labels[:, n * chunk:])
    return total / (b * s)
