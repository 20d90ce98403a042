"""The gather engine's sparse ops (dropclip_tpu_torch.sparse.ops) against
dropclip_tpu.sparse.ops on seeded inputs with misses (index M) in every
map: row gathers, the kernel-map conv (stride 1 and the k2s2 down map)
and the transposed k2s2 conv, batched and single-scene, float32."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.sparse import ops as jops
from dropclip_tpu_torch.sparse import ops


def _maps(rng, shape, m_in, miss=0.3):
    idx = rng.randint(0, m_in, shape)
    return np.where(rng.rand(*shape) < miss, m_in, idx).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("batched", [False, True])
def test_gather_rows_matches_jax(batched):
    """Exact, misses read zeros."""
    rng = np.random.RandomState(0)
    feats = rng.randn(*((2,) if batched else ()), 20, 5).astype(np.float32)
    idx = _maps(rng, (2, 7, 3) if batched else (7, 3), 20)
    got = ops.gather_rows(_t(feats), _t(idx)).numpy()
    ref = np.asarray(jops.gather_rows(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, ref)
    assert (got[idx == 20] == 0).all()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("k,cin,cout,m_out", [(27, 6, 8, 40), (8, 4, 4, 9),
                                              (125, 3, 5, 40)])
def test_sparse_conv_matches_jax(batched, k, cin, cout, m_out):
    """The k3 and k5 maps of a level and a k2s2 down map, with an output
    mask: 1e-5 of max|ref| (the port sums the taps in one matmul, the JAX
    package tap by tap)."""
    rng = np.random.RandomState(k + cin)
    lead = (2,) if batched else ()
    feats = rng.randn(*lead, 40, cin).astype(np.float32)
    nbr = _maps(rng, lead + (k, m_out), 40)
    w = (rng.randn(k, cin, cout) * 0.3).astype(np.float32)
    mask = rng.rand(*lead, m_out) < 0.8
    got = ops.sparse_conv(_t(feats), _t(nbr), _t(w), _t(mask)).numpy()
    ref = np.asarray(jops.sparse_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                      jnp.asarray(w), jnp.asarray(mask)))
    assert got.shape == ref.shape == lead + (m_out, cout)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("batched", [False, True])
def test_sparse_conv_transpose_matches_jax(batched):
    """Fine voxels take their parent through W[offset]; a parent >= Mc (a
    miss) gives zeros: 1e-5 of max|ref|."""
    rng = np.random.RandomState(5)
    lead = (2,) if batched else ()
    coarse = rng.randn(*lead, 12, 6).astype(np.float32)
    parent = _maps(rng, lead + (30,), 12)
    offset = rng.randint(0, 8, lead + (30,)).astype(np.int32)
    w = rng.randn(8, 6, 5).astype(np.float32)
    mask = parent < 12
    got = ops.sparse_conv_transpose(_t(coarse), _t(parent), _t(offset), _t(w),
                                    _t(mask)).numpy()
    ref = np.asarray(jops.sparse_conv_transpose(
        jnp.asarray(coarse), jnp.asarray(parent), jnp.asarray(offset),
        jnp.asarray(w), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert (got[parent == 12] == 0).all()


def test_sparse_conv_accumulates_bf16_in_float32():
    """bf16 inputs: the taps are summed in float32 and rounded once, so
    the result is the float32 conv of the same bf16 values to one bf16
    rounding (2^-8 relative)."""
    rng = np.random.RandomState(1)
    feats = torch.as_tensor(rng.randn(2, 40, 16).astype(np.float32))
    nbr = torch.as_tensor(_maps(rng, (2, 27, 40), 40))
    w = torch.as_tensor(rng.randn(27, 16, 8).astype(np.float32) * 0.2)
    fb, wb = feats.bfloat16(), w.bfloat16()
    got = ops.sparse_conv(fb, nbr, wb)
    ref = ops.sparse_conv(fb.float(), nbr, wb.float())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -8,
                               atol=2 ** -8 * float(ref.abs().max()))
