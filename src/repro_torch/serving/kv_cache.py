"""Paged KV storage: a fixed pool of pages holding prefix-chunk KV.

Port of ``repro.serving.kv_cache``.  A page stores the K/V of
``page_tokens`` consecutive tokens for every layer (RoPE already applied,
so a page is reusable by any request sharing the same absolute-position
prefix).  The pool planes are device tensors; page allocation and
refcounting are host-side (numpy), as in the JAX package.

Eviction policy is NOT here: the pool only allocs/frees.  The multi-step
LRU prefix cache (prefix_cache.py) decides which page to reuse or evict.

Paged serving (``ServeEngine(kv_mode="paged")``) additionally keeps a
block-table plane here: per-slot page lists (host side, mirrored to a
device tensor on demand) plus slot-local *tail* storage for the tokens a
request computes itself.  In that mode the pool is the single resident copy
of every shared prefix — decode attends straight into pool pages through
the block table and ``gather_pages`` is never called (``gather_calls``
counts the copies the contiguous mode makes).  The device tensors are
updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import resolve_device


class PagedKVPool:
    """Device storage (L, n_pages, page_tokens, KVH, Dh) ×2 + host free list."""

    def __init__(self, cfg, n_pages: int, page_tokens: int = 64,
                 dtype=torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.n_pages = n_pages
        self.page_tokens = page_tokens
        self.device = resolve_device(device)
        shape = (cfg.n_layers, n_pages, page_tokens, cfg.n_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(n_pages - 1, -1, -1))
        self.refcount = np.zeros(n_pages, np.int32)
        self._deferred_free: set = set()
        self._reserved: set = set()
        self.gather_calls = 0          # contiguous-mode prefix copies made
        # paged-mode plane (allocated by attach_slots)
        self.block_tables: np.ndarray | None = None   # (slots, max_pages) i32
        self.prefix_lens: np.ndarray | None = None    # (slots,) i32
        self.tail_k = None
        self.tail_v = None
        self.tail_tokens = 0
        self._bt_device = None         # cached device mirror of block_tables

    # -- host bookkeeping ----------------------------------------------------
    def alloc(self) -> int | None:
        if not self._free:
            return None
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    # -- reserve-then-commit (batched admission under pool pressure) ---------
    # A fused serving tick stages page values for every chunk that *might*
    # insert before the cache call reveals which chunks actually do.
    # ``reserve`` takes a page tentatively; after the tick exactly one of
    # ``commit`` (the insert published it) or ``abort`` (the chunk hit / was
    # absorbed — hand the page straight back) runs per reservation.
    def reserve(self) -> int | None:
        p = self.alloc()
        if p is not None:
            self._reserved.add(p)
        return p

    def commit(self, page: int) -> None:
        self._reserved.discard(page)

    def abort(self, page: int) -> None:
        if page not in self._reserved:
            raise AssertionError(f"abort of unreserved page {page}")
        if self.refcount[page] != 1:
            raise AssertionError(
                f"abort of page {page} with refcount {self.refcount[page]}: "
                "reserved pages are unpublished and must not be pinned")
        self._reserved.discard(page)
        self.refcount[page] = 0
        self._free.append(page)

    def pin(self, page: int) -> None:
        self.refcount[page] += 1

    def unpin(self, page: int) -> None:
        if self.refcount[page] <= 1 and page not in self._deferred_free:
            # an unpin beyond the pin count would consume the cache's own
            # alloc reference and strand the page: fail loud instead
            raise AssertionError(
                f"unbalanced unpin of page {page}: refcount "
                f"{int(self.refcount[page])} with no deferred release")
        self.refcount[page] -= 1
        if self.refcount[page] <= 0 and page in self._deferred_free:
            # policy already evicted it; last reader gone -> really free
            self._deferred_free.discard(page)
            self.refcount[page] = 0
            self._free.append(page)

    def release(self, page: int) -> None:
        """Policy evicted this page; free now or defer until unpinned."""
        self.refcount[page] -= 1
        if self.refcount[page] <= 0:
            self.refcount[page] = 0
            self._free.append(page)
        else:
            self._deferred_free.add(page)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    # -- paged-mode plane: per-slot block tables + tail storage --------------
    # The tail holds the tokens a slot computes itself (suffix prefill +
    # decoded tokens) at tail position (abs_pos - prefix_len); everything
    # before prefix_len lives in pool pages named by the slot's block table.
    def attach_slots(self, slots: int, max_len: int, tail_tokens: int | None = None):
        """Allocate block tables + slot tails; returns the tail {"k","v"}."""
        max_pages = -(-max_len // self.page_tokens)
        self.tail_tokens = max_len if tail_tokens is None else tail_tokens
        self.block_tables = np.zeros((slots, max_pages), np.int32)
        self.prefix_lens = np.zeros(slots, np.int32)
        self._bt_device = None
        cfg = self.cfg
        shape = (cfg.n_layers, slots, self.tail_tokens, cfg.n_kv_heads, cfg.head_dim)
        self.tail_k = torch.zeros(shape, dtype=self.k.dtype, device=self.device)
        self.tail_v = torch.zeros(shape, dtype=self.v.dtype, device=self.device)
        return {"k": self.tail_k, "v": self.tail_v}

    def set_block_table(self, slot: int, pages) -> None:
        """Record slot's prefix as a page walk (prefix_len = len·page_tokens)."""
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(pages)] = pages
        self.prefix_lens[slot] = len(pages) * self.page_tokens
        self._bt_device = None

    def clear_slot(self, slot: int) -> None:
        self.block_tables[slot] = 0
        self.prefix_lens[slot] = 0
        self._bt_device = None

    def device_block_tables(self) -> torch.Tensor:
        """(slots, max_pages) int32 device mirror, refreshed only when dirty."""
        if self._bt_device is None:
            self._bt_device = torch.from_numpy(self.block_tables.copy()).to(self.device)
        return self._bt_device

    # -- device ops ------------------------------------------------------------
    def write_pages(self, pages, k_chunks, v_chunks) -> None:
        """k/v_chunks (L, n, page_tokens, KVH, Dh) -> pool rows ``pages``."""
        idx = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=self.device)
        self.k[:, idx] = k_chunks.to(self.k.dtype)
        self.v[:, idx] = v_chunks.to(self.v.dtype)

    def gather_pages(self, pages):
        """pages (n,) -> (L, n*page_tokens, KVH, Dh) contiguous K and V."""
        self.gather_calls += 1
        idx = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=self.device)
        n, l = len(idx), self.cfg.n_layers
        k, v = self.k[:, idx], self.v[:, idx]
        return (k.reshape(l, n * self.page_tokens, *k.shape[3:]),
                v.reshape(l, n * self.page_tokens, *v.shape[3:]))
