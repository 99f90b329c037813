"""The sharded cache's mesh: D logical shards on one device.

Port of ``repro.launch.mesh.make_cache_mesh``.  The JAX package runs the
sharded cache over a 1-D ``("cache",)`` mesh of D devices (D fake CPU
devices in its tests) and routes queries between them with
``jax.lax.all_to_all``.  NCCL does not put two ranks on one GPU, so the
port runs the D shards of that mesh as D logical shards in one process on
one device, the counterpart of the fake-device mesh.  On one device the
sharded engine makes no exchange (``core/sharded.py``: the route there and
back changes no result); ``all_to_all``, the exchange of every shard's send
buffers at once as a transpose of their stack, is the interface a
transport across cards implements.
"""

from __future__ import annotations

import torch

__all__ = ["CacheMesh", "make_cache_mesh"]


class CacheMesh:
    """D logical shards of the ``"cache"`` axis on ``device``.

    ``shape["cache"]`` is D, as on a JAX mesh; ``all_to_all`` exchanges
    the per-peer send buffers of all D shards."""

    def __init__(self, ndev: int, device):
        if ndev < 1:
            raise ValueError(f"a cache mesh needs at least one shard, got {ndev}")
        self.shape = {"cache": int(ndev)}
        self.device = torch.device(device)

    @property
    def ndev(self) -> int:
        return self.shape["cache"]

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` (D_src, D_dst, k, planes) int32: shard ``s`` sends
        ``send[s, d]`` to shard ``d``.  Returns the (D_dst, D_src, k,
        planes) stack each shard receives: ``recv[d, s] = send[s, d]``, the
        ``all_to_all(split_axis=0, concat_axis=0, tiled=True)`` of every
        shard at once."""
        d = self.ndev
        if send.shape[0] != d or send.shape[1] != d:
            raise ValueError(f"send buffers {tuple(send.shape)} on a mesh of {d} shards")
        return send.transpose(0, 1).contiguous()

    def __repr__(self) -> str:
        return f"CacheMesh(cache={self.ndev}, device={self.device})"


def make_cache_mesh(n_devices: int | None = None, device="cuda") -> CacheMesh:
    """A mesh of ``n_devices`` logical cache shards on ``device`` (the card
    unless the caller asks for the CPU).  ``None`` gives one shard per
    visible card (one on the CPU), as the JAX mesh takes every device."""
    from repro_torch.core import resolve_device

    device = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    return CacheMesh(n_devices, device)
