"""The port's one-pass engine against the JAX package's on batches built of
long repeated runs (``torch_run_cases``): a Zipf batch whose hot key starts
deep in its set, runs that start, end and carry across 32-member windows,
runs broken by the valid mask and by a ``max_rounds`` cap, runs of every
opcode with dead chain members, runs on the cost plane, equal keys with
unequal values, and two key planes under set_lru.

The JAX engine runs its Pallas one-pass kernel in interpret mode, in blocks
of 128 queries, so chains also cross its grid blocks; the port runs its
plain version on the CPU.  (table, AccessResult, served) must match bit
for bit.  ``test_torch_cuda.py`` holds the CUDA kernel against the plain
version on the same batches.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import engine as jax_engine
from repro.kernels.ops import onepass_update as jax_onepass_update
from repro_torch.core import MSLRUConfig, set_index_for
from repro_torch.kernels.ops import onepass_update
from torch_run_cases import run_cases

CASES = run_cases()


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_onepass_runs_match_jax(case):
    jcfg, cfg = JaxConfig(**case.kw), MSLRUConfig(**case.kw)
    want = jax_onepass_update(
        jcfg, jnp.asarray(case.table),
        jax_engine.set_index_for(jcfg, jnp.asarray(case.keys)),
        jnp.asarray(case.valid), jnp.asarray(case.keys), jnp.asarray(case.vals),
        case.max_rounds, use_kernel=True, block_b=128, interpret=True,
        ops=_jnp(case.ops), chain_live=_jnp(case.chain_live), costs=_jnp(case.costs))
    keys = _t(case.keys)
    got = onepass_update(cfg, _t(case.table), set_index_for(cfg, keys), _t(case.valid),
                         keys, _t(case.vals), case.max_rounds, ops=_t(case.ops),
                         chain_live=_t(case.chain_live), costs=_t(case.costs))
    for name, w, g in zip(["table", "result", "served"], want, got):
        if name == "result":
            for field, wf, gf in zip(w._fields, w, g):
                np.testing.assert_array_equal(gf.numpy(), np.asarray(wf),
                                              err_msg=f"{case.name}: {field}")
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{case.name}: {name}")


def _runs_in_chains(case):
    """(start, length, chain rank of the start) of every run of equal
    operands in the batch sorted by set id, as the one-pass engine sees it."""
    cfg = MSLRUConfig(**case.kw)
    sids = set_index_for(cfg, _t(case.keys)).numpy()
    order = np.argsort(sids, kind="stable")
    ops = np.zeros(len(order), np.int32) if case.ops is None else case.ops
    rows = np.concatenate([case.keys, case.vals, ops[:, None]], 1)[order]
    s = sids[order]
    new_chain = np.concatenate([[True], s[1:] != s[:-1]])
    new_run = new_chain | np.concatenate([[True], (rows[1:] != rows[:-1]).any(1)])
    starts = np.flatnonzero(new_run)
    heads = np.maximum.accumulate(np.where(new_chain, np.arange(len(s)), 0))
    return starts, np.diff(np.append(starts, len(s))), starts - heads[starts]


def test_run_cases_hold_long_runs():
    """The batches hold what they are built for: a hot key asked for at
    least 100 times whose set sees runs longer than a window, and runs that
    carry across a 32-member window boundary of their chain."""
    hot = CASES[0]
    assert np.unique(hot.keys[:, 0], return_counts=True)[1].max() >= 100
    assert _runs_in_chains(hot)[1].max() > 32
    for case in CASES[1:5]:
        _, length, rank = _runs_in_chains(case)
        crossing = (rank % 32 + length > 32) & (rank % 32 > 0)
        assert crossing.sum() >= 3, case.name
