"""The port's hand-written kernels against their plain PyTorch versions on
the card: K1 (``kernels/brick_conv3.py``, CUDA C++) and K6
(``ops/layernorm.py``, Triton).

Marked ``cuda``: without a card every test skips. This file imports
neither jax nor the JAX package, so it also runs on the card's machine,
where ``tests/conftest.py`` (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.kernels.brick_conv3 import (brick_conv3,
                                                    brick_conv3_plain)
from dropclip_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain
from dropclip_tpu_torch.sparse import bricks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _folded_level(bshape, level, seed=0):
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), 2, 1024,
                                        n_occ=800, ext=16)
    caps = bricks.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    topo = bricks.build_brick_topology(
        torch.as_tensor(coords, device="cuda"),
        torch.as_tensor(mask, device="cuda"), brick_capacities=caps,
        brick_shape=bshape)
    return bricks.fold_topology(topo).levels[level]


@pytest.mark.parametrize("bshape", [(4, 4, 2), (4, 4, 4), (2, 2, 2),
                                    (8, 8, 4)])
@pytest.mark.parametrize("c,cout", [(32, 32), (416, 384), (3, 200)])
def test_k1_matches_plain(cuda, bshape, c, cout):
    """float32 (TF32 off): rtol 1e-4 plus atol 1e-4 * max|ref|, the
    summation order of 27*C terms; bf16 inputs with f32 accumulation:
    1e-2 of max|ref| (one bf16 rounding of the output)."""
    lv = _folded_level(bshape, level=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    occ = lv.occ[..., None].float()
    x = torch.randn(tuple(lv.occ.shape) + (c,), generator=gen,
                    device=cuda) * occ
    w = torch.randn((27, c, cout), generator=gen, device=cuda) * (
        2.0 / (27 * cout)) ** 0.5
    before = brick_conv3.launches
    got = brick_conv3(x, lv.nbr, w, lv.occ)
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ)
    torch.cuda.synchronize()
    assert brick_conv3.launches == before + 1
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    xb, wb = x.bfloat16(), w.bfloat16()
    got = brick_conv3(xb, lv.nbr, wb, lv.occ).float()
    ref = brick_conv3_plain(xb, lv.nbr, wb, lv.occ).float()
    assert float((got - ref).abs().max()) <= 1e-2 * float(ref.abs().max())


def test_k1_reads_misses_as_zeros(cuda):
    """Any neighbour row outside [0, Bm) reads zeros (never
    dereferenced). The centre tap comes from nbr[:, 13], which real
    topologies set to the row itself, as here."""
    bm, c, cout = 6, 16, 8
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((bm, 4, 4, 2, c), generator=gen, device=cuda)
    w = torch.randn((27, c, cout), generator=gen, device=cuda)
    nbr = torch.randint(0, bm, (bm, 27), generator=gen, device=cuda,
                        dtype=torch.int32)
    nbr[:, 13] = torch.arange(bm, device=cuda, dtype=torch.int32)
    nbr[0, torch.arange(27, device=cuda) != 13] = bm
    nbr[1, :5] = 2 ** 30
    nbr[2, 20:] = -1
    occ = torch.rand((bm, 4, 4, 2), generator=gen, device=cuda) > 0.3
    got = brick_conv3(x, nbr, w, occ)
    ref = brick_conv3_plain(x, nbr.clamp(-1, bm).where(nbr >= 0, bm), w,
                            occ)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_k1_wrapper_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((2, 4, 4, 2, 8), device=cuda)
    nbr = torch.zeros((2, 27), dtype=torch.int32, device=cuda)
    occ = torch.ones((2, 4, 4, 2), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        brick_conv3(x.half(), nbr, torch.zeros((27, 8, 4), device=cuda,
                                               dtype=torch.half), occ)
    with pytest.raises(ValueError):
        brick_conv3(x, nbr.cpu(), torch.zeros((27, 8, 4), device=cuda), occ)


@pytest.mark.parametrize("rows,c", [(308, 768), (77, 768), (5, 1000),
                                    (3, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain(cuda, rows, c, dtype):
    """float32: rtol 1e-5, atol 1e-5 (reduction order); bf16 in/out: at
    most one bf16 ulp of the plain result."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn((rows, c), generator=gen, device=cuda) * 3
         + torch.randn((1, c), generator=gen, device=cuda)).to(dtype)
    s = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    b = 0.1 * torch.randn(c, generator=gen, device=cuda)
    before = layer_norm.launches
    got = layer_norm(x, s, b)
    ref = layer_norm_plain(x, s, b)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1 and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        ref = ref.float()
        ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(
            torch.finfo(torch.float32).tiny))) - 7)
        assert bool(((got.float() - ref).abs() <= ulp).all())
