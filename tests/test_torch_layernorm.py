"""K6 plain version (dropclip_tpu_torch.ops.layernorm) against the JAX
LayerNorm: the jnp branch of ops.layernorm.layer_norm and the Pallas
kernel itself in interpret mode; K6's and K7's launch configuration, and
the module on a machine without triton."""

import os
import subprocess
import sys

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", [(600, 256), (77, 128)])
def test_k7_plain_matches_pallas_interpret(dtype, rows, c):
    """K7 plain (add_layer_norm on CPU tensors) against the TPU kernel
    (_pallas_fused, interpret mode): the sum bit-equal (one rounding of
    the float32 sum to the stream dtype); y in float32 within rtol 1e-5,
    atol 1e-5; y in bf16 within one bf16 ulp."""
    from dropclip_tpu_torch.ops.layernorm import add_layer_norm

    x, s, b = _inputs(rows, c, seed=3)
    d = np.random.RandomState(4).randn(rows, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref_s, ref_y = jln._pallas_fused(
        jnp.asarray(x, jdt), jnp.asarray(d, jdt), jnp.asarray(s),
        jnp.asarray(b), eps=1e-5, interpret=True)
    ref_s = np.asarray(ref_s, np.float32)
    ref_y = np.asarray(ref_y, np.float32)
    got_s, got_y = add_layer_norm(
        torch.as_tensor(x).to(tdt), torch.as_tensor(d).to(tdt),
        torch.as_tensor(s), torch.as_tensor(b))
    assert add_layer_norm.launches == 0  # CPU tensors never launch K7
    assert got_s.dtype == got_y.dtype == tdt
    np.testing.assert_array_equal(got_s.float().numpy(), ref_s)
    got_y = got_y.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got_y, ref_y, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got_y - ref_y) <= _bf16_ulp(ref_y)).all()


@pytest.mark.parametrize("c,want", [
    (384, (512, 2, 1)),     # DINO v1 S/8: a warp per row, 2 rows a program
    (768, (1024, 1, 4)),    # ViT-L/14's text tower
    (1024, (1024, 1, 4)),   # ViT-L/14's vision tower, DINOv2-L
    (512, (512, 2, 1)), (32, (32, 2, 1)), (1, (1, 2, 1)),
    (513, (1024, 1, 4)), (1280, (2048, 1, 8))])
def test_launch_config_by_width(c, want):
    """(BLOCK, ROWS, num_warps) at DINO v1's 3026 rows (224x224): rows of
    512 lanes or fewer go one warp each, two to a program; wider rows one
    to a program of 4 warps (8 above 1024 lanes)."""
    from dropclip_tpu_torch.ops.layernorm import launch_config

    assert launch_config(3026, c) == want


@pytest.mark.parametrize("n_rows,c,want", [
    (4 * 77, 512, (512, 1, 4)),     # RN50's text tower on 4 prompts
    (4 * 77, 768, (1024, 1, 4)),    # ViT-L/14's text tower on 4 prompts
    (1023, 384, (512, 1, 4)), (1024, 384, (512, 2, 1)),
    (16130, 384, (512, 2, 1)),      # DINO v1 S/8 at 512x512
    (96 * 769, 1024, (1024, 1, 4)),  # the ViT-L teacher's 96 crops
    (1, 1, (1, 1, 4))])
def test_launch_config_by_rows(n_rows, c, want):
    """Below 1024 rows a narrow row keeps a program of 4 warps: the
    one-warp programs would leave most of the card's SMs idle."""
    from dropclip_tpu_torch.ops.layernorm import launch_config

    assert launch_config(n_rows, c) == want


def test_module_runs_without_triton():
    """With triton absent the module imports, picks its launch
    configuration and runs both plain versions on CPU tensors, building
    and compiling nothing."""
    code = ("import sys\n"
            "sys.modules['triton'] = None\n"
            "import torch\n"
            "from dropclip_tpu_torch.ops import layernorm as ln\n"
            "assert ln.launch_config(3026, 384) == (512, 2, 1)\n"
            "x = torch.randn(5, 384)\n"
            "s, b = torch.ones(384), torch.zeros(384)\n"
            "ln.layer_norm(x, s, b)\n"
            "ln.add_layer_norm(x, x, s, b)\n"
            "assert not ln._kernels\n"
            "assert ln.layer_norm.launches == ln.add_layer_norm.launches == 0\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
