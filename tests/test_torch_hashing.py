"""Hashing parity: the port's uint32-in-int64 arithmetic against the JAX
package's uint32 lanes, bit for bit (set ids must match or no table can)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import MSLRUConfig as JaxConfig
from repro.core import hashing as jax_hashing
from repro.core.multistep import set_index_for as jax_set_index_for
from repro_torch.core import MSLRUConfig, hashing
from repro_torch.core.multistep import set_index_for

SPECIALS = np.array([0, 1, -1, -(2**31), 2**31 - 1, 0x7FFF, -0x8000], np.int32)


def _int32s(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    x[:len(SPECIALS)] = SPECIALS
    return x


def _u32(a):
    return np.asarray(a).astype(np.uint32).astype(np.int64)


def test_fmix32_matches_jax():
    x = _int32s(0)
    np.testing.assert_array_equal(hashing.fmix32(torch.from_numpy(x)).numpy(),
                                  _u32(jax_hashing.fmix32(jnp.asarray(x))))


def test_fmix64_planes_matches_jax():
    hi, lo = _int32s(1), _int32s(2)[::-1].copy()
    jh, jl = jax_hashing.fmix64_planes(jnp.asarray(hi), jnp.asarray(lo))
    th, tl = hashing.fmix64_planes(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(th.numpy(), _u32(jh))
    np.testing.assert_array_equal(tl.numpy(), _u32(jl))


def test_fmix_reference_vectors():
    f = hashing.fmix32(torch.tensor([0, 1, -1], dtype=torch.int32)).tolist()
    assert f == [0, 0x514E28B7, 0x81F16F39]
    hi, lo = hashing.fmix64_planes(torch.tensor([0]), torch.tensor([1]))
    assert (int(hi) << 32) | int(lo) == 0xB456BCFC34C2CB2C


def test_fold_token_hash_matches_jax():
    h, t = _int32s(3), _int32s(4)
    np.testing.assert_array_equal(
        hashing.fold_token_hash(torch.from_numpy(h), torch.from_numpy(t)).numpy(),
        _u32(jax_hashing.fold_token_hash(jnp.asarray(h), jnp.asarray(t))))


@pytest.mark.parametrize("key_planes", [1, 2])
@pytest.mark.parametrize("num_sets", [1, 16, 2**21])
def test_set_index_for_matches_jax(key_planes, num_sets):
    keys = np.stack([_int32s(5 + p) for p in range(key_planes)], -1)
    got = set_index_for(MSLRUConfig(num_sets=num_sets, key_planes=key_planes),
                        torch.from_numpy(keys))
    want = jax_set_index_for(JaxConfig(num_sets=num_sets, key_planes=key_planes),
                             jnp.asarray(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
