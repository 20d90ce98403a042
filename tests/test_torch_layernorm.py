"""K6 plain version (dropclip_tpu_torch.ops.layernorm) against the JAX
LayerNorm: the jnp branch of ops.layernorm.layer_norm and the Pallas
kernel itself in interpret mode."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.ops import layernorm as jln
from dropclip_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain


def _inputs(rows, c, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, c) * 3 + rng.randn(1, c)).astype(np.float32)
    s = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    return x, s, b


def _bf16_ulp(v):
    """bf16 spacing at |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("shape", [(308, 768), (77, 32), (5, 1000)])
def test_plain_matches_jnp_f32(shape):
    """float32: equal to reduction-order rounding (rtol 1e-5, atol 1e-5)."""
    x, s, b = _inputs(*shape)
    ref = np.asarray(jln.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(b)))
    got = layer_norm(torch.as_tensor(x), torch.as_tensor(s),
                     torch.as_tensor(b)).numpy()
    assert layer_norm.launches == 0  # CPU tensors never launch K6
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_plain_matches_jnp_bf16():
    """bf16 in/out (the text tower's serve dtype), f32 stats: within one
    bf16 ulp of the JAX output."""
    x, s, b = _inputs(4 * 77, 768, seed=1)
    xb = torch.as_tensor(x).bfloat16()
    ref = np.asarray(jln.layer_norm(jnp.asarray(x).astype(jnp.bfloat16),
                                    jnp.asarray(s), jnp.asarray(b)),
                     np.float32)
    got = layer_norm_plain(xb, torch.as_tensor(s),
                           torch.as_tensor(b)).float().numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (np.abs(got - ref) <= _bf16_ulp(ref)).all()


def test_plain_matches_pallas_interpret():
    """The TPU kernel (_pallas_ln, interpret mode) on a ragged row count:
    f32, rtol 1e-5, atol 1e-5."""
    x, s, b = _inputs(600, 256, seed=2)
    ref = np.asarray(jln._pallas_ln(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(b), eps=1e-5,
                                    interpret=True))
    got = layer_norm_plain(torch.as_tensor(x), torch.as_tensor(s),
                           torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
