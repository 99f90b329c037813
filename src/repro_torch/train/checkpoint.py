"""Atomic checkpoints in the JAX package's layout.

Port of ``repro.train.checkpoint``; a directory either package writes, the
other restores.  Layout:

    <dir>/step_<N>/manifest.json   step, time, {key: {shape, dtype}}, extra
    <dir>/step_<N>/shard_0.npz     the leaves by key
    <dir>/LATEST                   the last step written

Writes go to ``step_<N>.tmp/``, renamed to ``step_<N>/`` (atomic on POSIX),
and ``LATEST`` is rewritten last, so a crash mid-save never corrupts the
restore path.  bf16 leaves are stored as uint16 (numpy has no bf16) and
named ``bfloat16`` in the manifest; this module views them as
``torch.uint16`` bits, without ``ml_dtypes``.

Keys are the JAX ``_flatten`` of ``{"params": ..., "opt": OptState}``:
``params/blocks/attn/wq`` holds every layer's ``wq`` stacked on a leading
axis, as the JAX package stacks its layer stacks (an xLSTM group's mLSTM
blocks on a second one: ``params/blocks/mlstm/cell/wq`` is (groups, g-1,
...)); the optimizer's leaves are ``opt/.step``, ``opt/.master/<key>``,
``opt/.m/<key>`` and ``opt/.v/<key>``.  A port parameter's name maps to its
key and index by dropping the layer indices: ``blocks.3.mlstm.2.cell.wq``
is ``blocks/mlstm/cell/wq`` at (3, 2).

A sharded run's leaves are DTensors: a checkpoint holds their full tensors
in the same layout, as the JAX package's ``save`` holds ``jax.device_get``'s.
Every rank gathers them (``full_tensor``, a collective) and rank 0 of the
default process group writes; on restore every rank reads the full arrays
and copies its own block into its shard.  So a one-device checkpoint resumes
a sharded run and a sharded one a one-device run.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models.layers import is_dtensor
from repro_torch.train.optimizer import OptState


def _walk(tree, path=()):
    """(path components, tensor) for every leaf: modules by their
    parameters' dotted names, dicts by key, an ``OptState``'s fields as
    ``.step``, ``.master``, ... (the JAX path of a NamedTuple field)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield path + tuple(name.split(".")), p
    elif isinstance(tree, OptState):
        for field in OptState._fields:
            yield from _walk(getattr(tree, field), path + ("." + field,))
    else:
        for k, v in tree.items():
            yield from _walk(v, path + tuple(str(k).split(".")))


def _key(path):
    """A leaf's JAX key and its index in the stacked leaf."""
    return ("/".join(c for c in path if not c.isdigit()),
            tuple(int(c) for c in path if c.isdigit()))


def _writes() -> bool:
    """This process writes checkpoints: no process group, or its rank 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _host(tree):
    """The tree's leaves as host numpy arrays by JAX key (layers stacked),
    with each one's dtype name.  A DTensor leaf gives its full tensor (every
    rank of its mesh takes part)."""
    parts = {}
    for path, t in _walk(tree):
        key, idx = _key(path)
        t = t.detach()
        parts.setdefault(key, {})[idx] = t.full_tensor() if is_dtensor(t) else t
    arrays, dtypes = {}, {}
    for key, by_idx in sorted(parts.items()):
        first = next(iter(by_idx.values()))
        dims = tuple(max(i[d] for i in by_idx) + 1 for d in range(len(next(iter(by_idx)))))
        stacked = torch.empty(dims + tuple(first.shape), dtype=first.dtype)
        for idx, t in by_idx.items():
            stacked[idx] = t.cpu()
        if stacked.dtype == torch.bfloat16:
            arrays[key] = stacked.view(torch.int16).numpy().view(np.uint16)
            dtypes[key] = "bfloat16"
        else:
            arrays[key] = stacked.numpy()
            dtypes[key] = arrays[key].dtype.name
    return arrays, dtypes


def _write(ckpt_dir: Path, step: int, arrays: dict, dtypes: dict, extra: dict | None):
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    tmp.mkdir(exist_ok=True)
    np.savez(tmp / "shard_0.npz", **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in arrays.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest_tmp = ckpt_dir / "LATEST.tmp"
    latest_tmp.write_text(str(step))
    os.replace(latest_tmp, ckpt_dir / "LATEST")
    return final


def save(ckpt_dir: str | Path, step: int, tree, extra: dict | None = None) -> Path:
    """Write ``tree`` (e.g. ``{"params": ParamTree, "opt": OptState}``) as
    step ``step`` (in a process group: gathered by every rank, written by
    rank 0)."""
    arrays, dtypes = _host(tree)
    ckpt_dir = Path(ckpt_dir)
    return _write(ckpt_dir, step, arrays, dtypes, extra) if _writes() \
        else ckpt_dir / f"step_{step}"


class AsyncCheckpointer:
    """Background-thread writer; at most one outstanding save.  The device
    to host copy happens on the caller's thread, so training may update the
    tensors in place as soon as ``save`` returns."""

    def __init__(self, ckpt_dir: str | Path):
        self.ckpt_dir = Path(ckpt_dir)
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        arrays, dtypes = _host(tree)
        if not _writes():
            return
        self._thread = threading.Thread(
            target=_write, args=(self.ckpt_dir, step, arrays, dtypes, extra), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(ckpt_dir: str | Path, template, step: int | None = None):
    """Load step ``step`` (default: the latest) into ``template``'s tensors
    in place (each leaf checked against the manifest's shape, cast to the
    template's dtype, on the template's device; a DTensor leaf takes its
    rank's block).  Returns (template, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_0.npz") as data:
        loaded = {}
        for path, t in _walk(template):
            key, idx = _key(path)
            if key not in loaded:
                arr = data[key]
                if manifest["keys"][key]["dtype"] == "bfloat16":
                    loaded[key] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    loaded[key] = torch.from_numpy(arr)
            leaf = loaded[key][idx]
            if tuple(leaf.shape) != tuple(t.shape):
                raise ValueError(f"{key}{list(idx)}: checkpoint shape {tuple(leaf.shape)}, "
                                 f"template {tuple(t.shape)}")
            with torch.no_grad():
                if is_dtensor(t):
                    from repro_torch.launch.sharding import local_shard

                    t.to_local().copy_(local_shard(leaf, t.device_mesh, t.placements)
                                       .to(t.dtype))
                else:
                    t.copy_(leaf.to(t.dtype))
    return template, step
