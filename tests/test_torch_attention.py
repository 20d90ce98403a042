"""K3, K4 and K5 plain versions (dropclip_tpu_torch.ops.attention) against
the JAX package: the Pallas kernels in interpret mode (K3, K4) and K5's
CPU oracle, ``jax.nn.dot_product_attention``; the dispatch predicates
against the JAX ones; and the binding's choice of kernel instance."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.ops import attention as jatt
from dropclip_tpu_torch.ops import attention as att


def _qkv(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(3)]


def _bf16_ulp(v):
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("t,heads,d", [(64, 4, 32), (100, 8, 16),
                                       (129, 4, 32)])
def test_k3_plain_matches_pallas_interpret(t, heads, d):
    """float32, same body order: within 1e-5."""
    b, c = 2, heads * d
    q, k, v = _qkv((b, t, c), seed=t)
    ref = np.asarray(jatt.oneshot_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        interpret=True))
    got = att.oneshot_attention_packed(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), heads).numpy()
    assert att.oneshot_attention_packed.launches == 0  # CPU: plain version
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [13, 77, 128, 200])
def test_k4_plain_matches_pallas_interpret(t):
    """float32, T on and off the TPU's 128 tiling: within 1e-5."""
    q, k, v = _qkv((2, t, 3, 32), seed=t, scale=0.5)
    ref = np.asarray(jatt.oneshot_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = att.oneshot_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v)).numpy()
    assert got.shape == (2, t, 3, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_k4_plain_bf16_follows_the_tpu_body():
    """bf16 inputs: the unnormalised probabilities round to bf16 before
    P.V as in the TPU body; within one bf16 ulp at max|ref| of the
    interpret-mode kernel (XLA's CPU dot rounds bf16 logits otherwise
    than torch's float32 product, which shows at outputs near zero)."""
    q, k, v = _qkv((2, 60, 2, 16), seed=5)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jatt.oneshot_attention(qb, kb, vb, interpret=True),
                     np.float32)
    tb = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    got = att.oneshot_attention(*tb).float().numpy()
    assert np.abs(got - ref).max() <= _bf16_ulp(np.abs(ref).max())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [77, 300])
def test_k5_plain_matches_dot_product_attention(causal, t):
    """K5's JAX function delegates to the TPU flash kernel; its CPU oracle
    is ``jax.nn.dot_product_attention``: float32 within 1e-5, bf16 within
    one bf16 ulp at max|ref|."""
    q, k, v = _qkv((2, t, 4, 16), seed=t + causal)
    ref = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal))
    got = att.flash_attention_padded(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v), causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref_b = np.asarray(jax.nn.dot_product_attention(*jb, is_causal=causal),
                       np.float32)
    tb = [torch.as_tensor(x).bfloat16() for x in (q, k, v)]
    got_b = att.flash_attention_padded(*tb, causal).float().numpy()
    assert np.abs(got_b - ref_b).max() <= _bf16_ulp(np.abs(ref_b).max())


@pytest.mark.parametrize("t", [1, 13, 77, 769, 1370, 1800, 1920, 2048, 3026,
                               8192])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_dispatch_predicates_match_jax(t, d, causal):
    """The same shapes take the same route as in the JAX package."""
    for size in (2, 4):
        assert att.supports(t, d, causal, itemsize=size) == \
            jatt.supports(t, d, causal, itemsize=size)
        for heads in (1, 4, 6, 16):
            assert att.supports_packed(t, heads, d, causal, itemsize=size) \
                == jatt.supports_packed(t, heads, d, causal, itemsize=size)


@pytest.mark.parametrize("dtype,error", [(torch.float16, TypeError),
                                         (torch.float32, ValueError),
                                         (torch.bfloat16, ValueError)])
def test_kernel_binding_checks_before_any_build(dtype, error):
    """The binding takes bfloat16 and float32 CUDA tensors only: a float16
    tensor is refused for its dtype, and a CPU tensor of a taken dtype for
    its device, both before nvcc or the card is needed."""
    from dropclip_tpu_torch.kernels.attention import attention

    q = torch.zeros((1, 8, 2, 64), dtype=dtype)
    with pytest.raises(error):
        attention(q, q, q, 2)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "v3"), (torch.bfloat16, 32, "v2"),
    (torch.bfloat16, 16, "v2"), (torch.float32, 64, "f32x3"),
    (torch.float32, 32, "f32x3"), (torch.float32, 16, "f32x3"),
    (torch.float16, 64, TypeError), (torch.float64, 32, TypeError),
    (torch.bfloat16, 48, ValueError), (torch.bfloat16, 128, ValueError),
    (torch.float32, 8, ValueError)])
def test_kernel_instance_by_dtype_and_head_dim(dtype, d, want):
    """bf16 at D = 64 runs v3 (wgmma), bf16 at D = 16 and 32 v2
    (mma.sync), float32 at every head dim the 3xTF32 instance (wgmma at
    D = 64, mma.sync at 16 and 32); anything else raises."""
    from dropclip_tpu_torch.kernels.attention import instance

    if isinstance(want, str):
        assert instance(dtype, d) == want
    else:
        with pytest.raises(want):
            instance(dtype, d)


def test_kernel_binding_imports_without_nvcc():
    """Importing the binding and choosing an instance build and load
    nothing, even where no nvcc can be found."""
    code = ("import torch\n"
            "from dropclip_tpu_torch.kernels import attention as a\n"
            "from dropclip_tpu_torch.kernels.nvcc import LIBRARIES\n"
            "assert a.instance(torch.bfloat16, 64) == 'v3'\n"
            "assert a.instance(torch.float32, 64) == 'f32x3'\n"
            "assert LIBRARIES['attention']._lib is None\n")
    env = dict(os.environ, NVCC="/nonexistent/nvcc", PATH="/usr/bin:/bin")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                   check=True, timeout=120)
