"""int8 gradient compression (``repro_torch.train.compression``) against the
JAX package's ``repro.train.compression``.

* JAX's four tests as port cases: the round trip within half a scale, the
  compressed all-reduce of one shard within quantization error, error
  feedback's time average, the byte accounting.
* ``quantize_int8`` / ``dequantize_int8`` bit-equal to JAX's on seeded
  inputs (normal, heavy-tailed, exact halves of the scale, zeros).
* ``compressed_all_reduce`` in a gloo group of one equals
  ``compressed_psum`` under a one-device ``shard_map``, value and residual
  (XLA rounds the residual ``g - q * scale`` once, a fused multiply-add;
  the port rounds it once too).
* ``compress_tree`` over D = 2 and 4 gloo ranks, two rounds carrying the
  residuals, equals the sum of JAX's per-rank ``quantize_int8`` as int32
  times the largest scale, bit for bit, residuals included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.mesh import make_mesh_compat, shard_map_compat
from repro.train import compression as jcomp
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.train.compression import (compress_tree, compressed_all_reduce,
                                           dequantize_int8, quantize_int8, zeros_residuals)
from torch_rank_fns import compress_rank


def _inputs(seed, n=4096):
    """Seeded f32 inputs: normal, heavy-tailed, values on exact halves of
    the scale (round half to even decides them), all zeros."""
    rng = np.random.default_rng(seed)
    halves = (rng.integers(-254, 255, n) / 2).astype(np.float32)
    halves[0] = 127.0                       # scale exactly 1.0
    return {"normal": rng.standard_normal(n).astype(np.float32),
            "heavy": (rng.standard_cauchy(n) * 1e-3).astype(np.float32),
            "halves": halves,
            "zeros": np.zeros(n, np.float32),
            "matrix": (rng.standard_normal((64, 96)) * 0.02).astype(np.float32)}


def _jax_q(x):
    q, s = jcomp.quantize_int8(jnp.asarray(x))
    return np.asarray(q), np.float32(s)


# ---------------------------------------------------------------------------
# JAX's four tests, as port cases
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded():
    x = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1000,))))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


def test_compressed_all_reduce_single_rank_matches():
    """A group of one: the compressed all-reduce is the identity up to
    quantization."""
    g = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64,))))
    with _group_of_one() as group:
        out, _ = compressed_all_reduce(g, group, torch.zeros_like(g))
    _, s = quantize_int8(g)
    np.testing.assert_allclose(out.numpy(), g.numpy(), atol=float(s) * 0.51)


def test_error_feedback_unbiased():
    """Reducing the same gradient again and again with error feedback: the
    time average of the dequantized stream equals the gradient."""
    g = torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(2), (256,)))) * 0.01
    r = torch.zeros_like(g)
    total = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        gc = g + r
        q, s = quantize_int8(gc)
        dq = dequantize_int8(q, s)
        r = gc - dq
        total = total + dq
    np.testing.assert_allclose((total / n).numpy(), g.numpy(), atol=5e-5)


def test_byte_reduction_accounting():
    """The stored values take a quarter of f32's bytes; the all-reduce sums
    them as int32, 4 bytes per element on the wire, as f32's."""
    g = torch.zeros((1024, 1024))
    q, _ = quantize_int8(g)
    assert q.nbytes * 4 == g.nbytes
    assert q.to(torch.int32).nbytes == g.nbytes


# ---------------------------------------------------------------------------
# against JAX, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_equals_jax_bit_for_bit(seed):
    for name, x in _inputs(seed).items():
        q, s = quantize_int8(torch.from_numpy(x))
        wq, ws = _jax_q(x)
        assert s.dtype == torch.float32 and q.dtype == torch.int8, name
        assert np.float32(s.item()).tobytes() == ws.tobytes(), name
        assert np.array_equal(q.numpy(), wq), name
        assert np.array_equal(dequantize_int8(q, s).numpy(),
                              np.asarray(jcomp.dequantize_int8(jnp.asarray(wq),
                                                               jnp.asarray(ws)))), name
    assert np.array_equal(quantize_int8(torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]))[0].numpy(),
                          [0, 2, 2, 0, 127])        # half to even, scale 1


class _group_of_one:
    """A gloo process group of one in this process, torn down after."""

    def __enter__(self):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        return dist.group.WORLD

    def __exit__(self, *exc):
        dist.destroy_process_group()


def test_compressed_all_reduce_d1_equals_jax_psum():
    """One rank: value and new residual equal ``compressed_psum`` under a
    one-device ``shard_map``, bit for bit, from a nonzero residual."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal(1000).astype(np.float32)
    r = (rng.standard_normal(1000) * 1e-3).astype(np.float32)
    mesh = make_mesh_compat((1,), ("d",))
    fn = jax.jit(shard_map_compat(lambda g, r: jcomp.compressed_psum(g, "d", r), mesh=mesh,
                                  in_specs=(jax.sharding.PartitionSpec(),) * 2,
                                  out_specs=(jax.sharding.PartitionSpec(),) * 2))
    want_out, want_r = (np.asarray(x) for x in fn(jnp.asarray(g), jnp.asarray(r)))
    with _group_of_one() as group:
        out, new_r = compressed_all_reduce(torch.from_numpy(g), group, torch.from_numpy(r))
        tree, res = compress_tree({"a": [torch.from_numpy(g)]}, group,
                                  {"a": [torch.from_numpy(r)]})
    assert np.array_equal(out.numpy(), want_out) and np.array_equal(new_r.numpy(), want_r)
    assert np.array_equal(tree["a"][0].numpy(), want_out)
    assert np.array_equal(res["a"][0].numpy(), want_r)
    z = zeros_residuals({"a": [torch.ones(3, 2, dtype=torch.bfloat16)], "b": torch.ones(4)})
    assert z["a"][0].dtype == torch.float32 and z["a"][0].shape == (3, 2)
    assert not z["b"].any()


@jax.jit
def _jax_local(g, r):
    """One rank's side of ``compressed_psum``, jitted as it runs there:
    (q, scale, new residual)."""
    gc = g + r
    q, s = jcomp.quantize_int8(gc)
    return q, s, gc - jcomp.dequantize_int8(q, s)


def _jax_rounds(grads, residuals, rounds):
    """The formula with JAX's quantization: each round, every rank's int8
    values summed as int32 times the largest scale; each rank's residual
    carried."""
    res = [dict(r) for r in residuals]
    out = []
    for _ in range(rounds):
        red = {}
        for k in grads[0]:
            qs = []
            for i, g in enumerate(grads):
                q, s, nr = _jax_local(jnp.asarray(g[k]), jnp.asarray(res[i][k]))
                res[i][k] = np.asarray(nr)
                qs.append((np.asarray(q), np.float32(s)))
            total = np.sum([q.astype(np.int32) for q, _ in qs], axis=0)
            smax = max(s for _, s in qs)
            red[k] = np.asarray(jnp.asarray(total).astype(jnp.float32) * smax)
        out.append(red)
    return out, res


@pytest.mark.parametrize("ndev", [2, 4])
def test_compress_tree_over_gloo_ranks_equals_jax_formula(ndev):
    """Two rounds over D ranks, each with its own seeded gradient tree and
    residual: every rank's reduced tree equals the formula over JAX's
    quantization, bit for bit, and its residual equals JAX's."""
    rng = np.random.default_rng(ndev)
    shapes = {"wq": (48, 64), "scale": (64,), "w_down": (96, 48)}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** -rng.integers(1, 4)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(ndev)]
    residuals = [{k: (rng.standard_normal(s) * 1e-4).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(ndev)]
    ranks = run_on_ranks(compress_rank, ndev, "gloo", "cpu", args=(grads, residuals, 2))
    want, want_res = _jax_rounds(grads, residuals, 2)
    for r, (reduced, res) in enumerate(ranks):
        for rnd in range(2):
            for k in shapes:
                assert np.array_equal(reduced[rnd][k], want[rnd][k]), (r, rnd, k)
        for k in shapes:
            assert np.array_equal(res[k], want_res[r][k]), (r, k)
