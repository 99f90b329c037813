"""Row transition parity: the port's ``msl_access_plain`` (and the CPU path
of its kernel wrapper) against the JAX package's ``msl_access_ref`` on the
kernel tests' seven geometries plus a cost-plane geometry, with random
rows, mixed opcodes, chain execute masks and insert costs.  Bit-exact."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import invector as jax_invector
from repro.kernels.ref import msl_access_ref as jax_msl_access_ref
from repro_torch.core import MSLRUConfig, invector
from repro_torch.kernels.msl_cache import (msl_access_kernel_call,
                                           msl_access_plain)
from test_kernels import GEOMS, _random_case

# (m, p, key_planes, value_planes, policy, cost_planes)
ROW_GEOMS = [g + (0,) for g in GEOMS] + [(2, 4, 1, 2, "multistep", 1)]
VARIANTS = ["access", "mixed_ops", "chain_live"]
OUT_NAMES = ["rows", "hit", "pos", "value", "evicted"]


def random_rows_case(geom, seed, b=257):
    """(cfg kwargs, rows, qkeys, qvals, ops, chain_live, costs) as numpy.

    Rows and keys come from the JAX kernel tests' ``_random_case``; a cost
    plane, when present, takes small values so that victim ties occur.
    """
    m, p, kp, v, policy, cost = geom
    rng = np.random.default_rng(seed)
    rows, qk, qv = _random_case(rng, m, p, kp, v + cost, b)
    if cost:
        rows[:, :, -1] = rng.integers(0, 3, rows.shape[:2])
    qv = np.ascontiguousarray(qv[:, :v]).reshape(b, v)
    ops = rng.integers(0, 6, b).astype(np.int32)
    live = (rng.random(b) < 0.5).astype(np.int32)
    costs = rng.integers(0, 5, b).astype(np.int32)
    kw = dict(num_sets=64, m=m, p=p, key_planes=kp, value_planes=v,
              cost_planes=cost, policy=policy)
    return kw, rows, qk, qv, ops, live, costs


def variant_operands(variant, ops, live, costs, cost_planes):
    """(ops, chain_live, costs) a variant passes (None where it passes none)."""
    return {"access": (None, None, costs if cost_planes else None),
            "mixed_ops": (ops, None, costs),
            "chain_live": (ops, live, costs)}[variant]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("geom", ROW_GEOMS, ids=lambda g: "-".join(map(str, g)))
def test_msl_access_plain_matches_jax(geom, variant):
    kw, rows, qk, qv, ops, live, costs = random_rows_case(geom, seed=sum(geom[:4]))
    extra = variant_operands(variant, ops, live, costs, kw["cost_planes"])
    want = jax.jit(jax_msl_access_ref, static_argnums=3)(jnp.asarray(rows), jnp.asarray(qk), jnp.asarray(qv),
                              JaxConfig(**kw),
                              *(None if x is None else jnp.asarray(x) for x in extra))
    t = [None if x is None else torch.from_numpy(x) for x in extra]
    args = (torch.from_numpy(rows), torch.from_numpy(qk), torch.from_numpy(qv), *t)
    cfg = MSLRUConfig(**kw)
    for got in (msl_access_plain(*args, cfg=cfg), msl_access_kernel_call(*args, cfg=cfg)):
        for name, w, g in zip(OUT_NAMES, want, got):
            assert g.dtype == torch.int32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} mismatch")


def test_kernel_wrapper_refuses_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises; it never falls
    back to the plain version."""
    cfg = MSLRUConfig(num_sets=4, m=2, p=4, value_planes=1)
    rows = torch.zeros((2, 8, 2), dtype=torch.int32, device="meta")
    keys = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        msl_access_kernel_call(rows, keys, keys, cfg=cfg)


def test_invector_primitives_match_jax():
    """rotate_insert / find_key / find_deepest_empty / get_update_lo on
    single-plane rows, against the JAX package's lane primitives."""
    rng = np.random.default_rng(0)
    b, a = 300, 8
    rows = rng.integers(1, 20, (b, a)).astype(np.int32)
    rows[rng.random((b, a)) < 0.3] = invector.EMPTY_KEY
    key = rng.integers(1, 20, b).astype(np.int32)
    lo = rng.integers(0, a, b).astype(np.int32)
    hi = np.maximum(lo, rng.integers(0, a, b)).astype(np.int32)
    item = rng.integers(-50, 50, b).astype(np.int32)
    t = torch.from_numpy
    for name, got, want in [
        ("find_key", invector.find_key(t(rows), t(key)),
         jax_invector.find_key(jnp.asarray(rows), jnp.asarray(key))),
        ("find_deepest_empty", invector.find_deepest_empty(t(rows)),
         jax_invector.find_deepest_empty(jnp.asarray(rows))),
        ("get_update_lo", invector.get_update_lo(t(hi), 4),
         jax_invector.get_update_lo(jnp.asarray(hi), 4)),
    ]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    got = invector.rotate_insert(t(rows), t(lo), t(hi), t(item))
    want = jax_invector.rotate_insert(jnp.asarray(rows), jnp.asarray(lo),
                                      jnp.asarray(hi), jnp.asarray(item))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
