"""The cache cell's control: the reference put in the program's place with
one guarantee broken.

``UnorderedCache`` applies the reference transition to a whole batch at
once, every query against its set's row as it stood at the batch's start,
and keeps the row the set's last query produced.  That breaks the
configuration's first guarantee (a batch equals its queries one at a time,
in stream order): a key asked twice in one batch misses twice, and a set's
earlier queries in a batch are lost.  The check must fail it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mslbench.reference.msl_lru import EMPTY, set_of, transition


class Answers(NamedTuple):
    hit: torch.Tensor
    value: torch.Tensor
    pos: torch.Tensor
    evicted_key: torch.Tensor
    evicted_val: torch.Tensor
    evicted_valid: torch.Tensor


class UnorderedCache:
    def __init__(self, geom: dict, device):
        self.geom = geom
        s, w = geom["num_sets"], geom["m"] * geom["p"]
        self.table = torch.zeros((s, w, 1 + geom["value_planes"]), dtype=torch.int32,
                                 device=device)
        self.table[..., 0] = EMPTY

    def access(self, keys, vals):
        keys = keys.reshape(-1)
        sid = set_of(keys, self.geom["num_sets"])
        rows = self.table[sid]
        nk, nv, o = transition(rows[..., 0], rows[..., 1:], keys, vals,
                               self.geom["m"], self.geom["p"])
        order = torch.sort(sid, stable=True).indices          # last query of a set wins
        s_sorted = sid[order]
        last = torch.ones_like(s_sorted, dtype=torch.bool)
        last[:-1] = s_sorted[1:] != s_sorted[:-1]
        win = order[last]
        self.table[sid[win]] = torch.cat([nk[win, :, None], nv[win]], -1).to(torch.int32)
        return Answers(o["hit"], o["value"].to(torch.int32), o["pos"].to(torch.int32),
                       o["evicted_key"][:, None].to(torch.int32),
                       o["evicted_val"].to(torch.int32), o["evicted_valid"])
