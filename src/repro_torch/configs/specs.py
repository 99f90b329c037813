"""Input specs: meta-device stand-ins for every (arch × shape) cell.

Port of ``repro.configs.specs``.  Each spec is a tensor on
``device="meta"``: it has the shape and dtype of the real input and
allocates nothing, as the JAX package's ``ShapeDtypeStruct``s do.  What the
dry run traces against.  For modality archs the frontend is a stub: whisper
gets precomputed frame embeddings, qwen2-vl gets M-RoPE position streams.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.model import Model

META = torch.device("meta")


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is meta, so that ``model.init`` (which
    draws on ``gen.device``) builds a parameter tree of meta tensors."""

    @property
    def device(self) -> torch.device:
        return META


def abstract_params(model: Model):
    """``model.init``'s parameter tree on the meta device (no allocation)."""
    return model.init(MetaGenerator())


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, batch: int | None = None):
    b = batch if batch is not None else shape.global_batch
    s = shape.seq_len
    specs = {
        "tokens": sds((b, s), torch.int32),
        "labels": sds((b, s), torch.int32),
    }
    if cfg.rope_kind == "mrope":
        specs["positions"] = sds((b, 3, s), torch.int32)
    if cfg.enc_dec:
        specs["frames"] = sds((b, cfg.enc_len, cfg.d_model), torch.bfloat16)
    return specs


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec, batch: int | None = None):
    specs = train_batch_specs(cfg, shape, batch)
    specs.pop("labels")
    return specs


def decode_specs(model: Model, shape: ShapeSpec, batch: int | None = None):
    """(tokens, cache, cur_len) specs for the serve step."""
    b = batch if batch is not None else shape.global_batch
    cache = model.init_cache(b, shape.seq_len, device=META)
    tokens = sds((b, 1), torch.int32)
    cur_len = sds((), torch.int32)
    return tokens, cache, cur_len


def applicable_shapes(cfg: ArchConfig):
    """The shape cells this arch runs (long_500k gated by supports_long)."""
    out = []
    for name, sh in SHAPES.items():
        if name == "long_500k" and not cfg.supports_long:
            continue
        out.append(sh)
    return out
