"""Core multi-step LRU cache library in PyTorch (port of ``repro.core``).

Public API:
    MSLRUConfig        — static cache geometry (S sets × M vectors × P lanes)
    MultiStepLRUCache  — stateful host-side wrapper on one device
    table_from_numpy / table_to_numpy — carry a cache table between this
                         package and the JAX package (as numpy int32)
    params_from_numpy  — carry the JAX package's model parameters (as
                         numpy arrays) into this package's model
    row/engine functions — see multistep.py and engine.py
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.multistep import (  # noqa: F401
    AccessResult,
    MSLRUConfig,
    OP_ACCESS,
    OP_CHAIN_GET,
    OP_CHAIN_PUT,
    OP_DELETE,
    OP_GET,
    OP_LOOKUP,
    init_table,
    row_access,
    row_apply,
    row_delete,
    row_get,
    row_lookup,
    row_put,
    set_index_for,
)
from repro_torch.core.engine import (  # noqa: F401
    SeqOutputs,
    engine_from_update,
    make_batched_engine,
    make_chunked_stream_runner,
    make_conflict_update,
    make_sequential_engine,
    pad_dummy_row,
)
from repro_torch.core.invector import EMPTY_KEY  # noqa: F401

__all__ = [
    "MSLRUConfig",
    "MultiStepLRUCache",
    "AccessResult",
    "OP_ACCESS",
    "OP_GET",
    "OP_DELETE",
    "OP_LOOKUP",
    "OP_CHAIN_GET",
    "OP_CHAIN_PUT",
    "init_table",
    "EMPTY_KEY",
    "resolve_device",
    "params_from_numpy",
    "table_from_numpy",
    "table_to_numpy",
]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return device


def table_from_numpy(np_table, device="cuda") -> torch.Tensor:
    """A cache table (S, A, C) from numpy (e.g. ``np.asarray`` of the JAX
    package's table) as a contiguous int32 tensor on ``device``."""
    arr = np.require(np_table, np.int32, ["C_CONTIGUOUS", "WRITEABLE"])
    if arr.ndim != 3:
        raise ValueError(f"a cache table is (S, A, C), got shape {arr.shape}")
    return torch.from_numpy(arr).to(resolve_device(device))


def table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """A cache table as a numpy int32 array (S, A, C)."""
    return table.detach().to("cpu", torch.int32).numpy()


def params_from_numpy(tree: dict, cfg, device="cuda"):
    """The JAX package's parameter pytree, as numpy arrays, as this
    package's model parameters (``models.model.ParamTree``) on ``device``.
    The JAX package stacks each layer stack's leaves along a leading axis;
    here each layer is a tree of its own: ``blocks`` (``n_layers`` blocks, or
    xLSTM's ``n_layers / scan_group`` groups, each with its ``scan_group - 1``
    mLSTM blocks stacked once more), Whisper's ``enc`` (``n_enc_layers``) and
    ``dec`` (``n_layers``).  Every other leaf (``head``, hymba's ``meta``,
    Whisper's ``enc_norm``) comes as it is.  Each leaf keeps its JAX value
    and dtype (bf16 weights stay bf16; f32 leaves, such as the norms, the MoE
    router, the Mamba and fuse vectors and the xLSTM gate biases and skip
    scale, stay f32).  ``cfg`` is the ``ArchConfig``."""
    from repro_torch.models.model import ParamTree

    device = resolve_device(device)
    xlstm = cfg.mixer == "xlstm"
    stacks = {"blocks": cfg.n_layers // cfg.scan_group if xlstm else cfg.n_layers,
              "enc": cfg.n_enc_layers, "dec": cfg.n_layers}

    def conv(x):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            dtype = torch.bfloat16
            arr = arr.astype(np.float32)   # exact; numpy has no bf16 of its own
        elif arr.dtype == np.float32:
            dtype = torch.float32
        else:
            raise TypeError(f"a parameter of dtype {arr.dtype}: expected bf16 or f32")
        arr = np.require(arr, requirements=["C_CONTIGUOUS", "WRITEABLE"])
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    def walk(t, index=()):
        if isinstance(t, dict):
            return {name: walk(v, index) for name, v in t.items()}
        return conv(np.asarray(t)[index])

    def layer(name, t, i):
        if name == "blocks" and xlstm:     # group i: its mLSTM blocks one by one
            return {"mlstm": [walk(t["mlstm"], (i, j)) for j in range(cfg.scan_group - 1)],
                    "slstm": walk(t["slstm"], (i,))}
        return walk(t, (i,))

    return ParamTree({name: [layer(name, v, i) for i in range(stacks[name])]
                      if name in stacks else walk(v)
                      for name, v in tree.items()})


class MultiStepLRUCache:
    """Stateful host-side wrapper around the cache engines on one device.

    >>> cache = MultiStepLRUCache(MSLRUConfig(num_sets=1024, m=2, p=4),
    ...                           device="cpu")
    >>> res = cache.access(np.array([42]))

    ``access`` runs the batched engine (``engine="onepass"``, the main path,
    or ``"rounds"``, its oracle); on a CUDA device both go through the CUDA
    kernels.  ``access_seq`` runs the sequential oracle.  The table is kept
    with the engines' dummy row appended, so a batch updates it in place;
    ``table`` is the (S, A, C) view of it.
    """

    def __init__(self, cfg: MSLRUConfig, engine: str = "onepass", device="cuda"):
        self.cfg = cfg
        self.engine = engine
        self.device = resolve_device(device)
        self._padded = pad_dummy_row(init_table(cfg, self.device))
        self._batched = engine_from_update(
            cfg, make_conflict_update(cfg, engine, in_place=True))
        self._seq = make_sequential_engine(cfg, with_ops=True)

    @property
    def table(self) -> torch.Tensor:
        return self._padded[:-1]

    def load_table(self, table) -> None:
        """Replace the cache's state with ``table`` (S, A, C): a tensor, or a
        numpy array such as the JAX package's table."""
        if not isinstance(table, torch.Tensor):
            table = table_from_numpy(table, self.device)
        shape = (self.cfg.num_sets, self.cfg.assoc, self.cfg.planes)
        if tuple(table.shape) != shape:
            raise ValueError(f"table shape {tuple(table.shape)} != {shape}")
        self._padded = pad_dummy_row(table.to(self.device, torch.int32))

    # -- batched high-throughput path ----------------------------------------
    def access(self, keys, vals=None, ops=None, chain_ids=None, costs=None):
        """Batched mixed-op call.  keys (B,) or (B, KP); vals (B, V); ops (B,)
        per-query opcodes (None = all OP_ACCESS); chain_ids (B,) segment ids
        for CHAIN_GET/CHAIN_PUT rows; costs (B,) insert costs (needs
        ``cfg.cost_planes``).  Returns an AccessResult."""
        qk, qv = self._canon(keys, vals)
        _, res = self._batched(self._padded, qk, qv, ops, chain_ids, costs)
        return res

    # -- exact sequential path -------------------------------------------------
    def access_seq(self, keys, vals=None, ops=None, chain_ids=None, costs=None):
        """The same call through the sequential oracle; returns SeqOutputs."""
        qk, qv = self._canon(keys, vals)
        table, out = self._seq(self.table, qk, qv, ops, chain_ids, costs)
        self._padded = pad_dummy_row(table)
        return out

    def _canon(self, keys, vals):
        keys = torch.as_tensor(keys, device=self.device).to(torch.int32)
        if keys.ndim == 1:
            keys = keys[:, None]
        if keys.shape[-1] != self.cfg.key_planes:
            raise ValueError(f"keys need {self.cfg.key_planes} plane(s)")
        if vals is None:
            vals = torch.zeros((keys.shape[0], self.cfg.value_planes),
                               dtype=torch.int32, device=self.device)
        vals = torch.as_tensor(vals, device=self.device).to(torch.int32)
        return keys.contiguous(), vals.reshape(keys.shape[0], self.cfg.value_planes)

    @property
    def occupancy(self) -> float:
        return float((self.table[:, :, 0] != EMPTY_KEY).float().mean())
