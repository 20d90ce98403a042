"""The port's hand-written kernels against their plain PyTorch versions on
the card: K1 (``kernels/brick_conv3.py``, CUDA C++), K2
(``kernels/pillar_conv3.py``, CUDA C++), K3, K4 and K5
(``ops/attention.py`` over ``csrc/attention.cu``, CUDA C++), and K6 and K7
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

from dropclip_tpu_torch.data.synthetic import (make_tabletop_coords,
                                               make_volumetric_coords)
from dropclip_tpu_torch.kernels.brick_conv3 import (brick_conv3,
                                                    brick_conv3_plain)
from dropclip_tpu_torch.kernels.pillar_conv3 import (pillar_conv3,
                                                     pillar_conv3_plain)
from dropclip_tpu_torch.ops import attention as att
from dropclip_tpu_torch.ops.layernorm import (add_layer_norm,
                                              add_layer_norm_plain,
                                              layer_norm, layer_norm_plain)
from dropclip_tpu_torch.sparse import bricks
from dropclip_tpu_torch.sparse.pillar_topology import build_pillar_topology

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
                                    (3, 32), (769, 1024), (96, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain(cuda, rows, c, dtype):
    """float32: rtol 1e-5, atol 1e-5 (reduction order); bf16 in/out: at
    most one bf16 ulp of the plain result. The 1024-wide rows are the
    ViT-L teacher's (ln_pre and block 0's ln_1 over a crop's 769 tokens,
    ln_post over 96 class tokens)."""
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


def _bf16_ulp(x):
    """bf16 spacing at |x| (8 significant bits)."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp_min(
        torch.finfo(torch.float32).tiny))) - 7)


def _qkv(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


def _assert_attention_close(got, ref):
    """Online softmax rounds the unnormalised probabilities against a
    running maximum, the plain version against the row's maximum: at most
    2 bf16 ulps of max|ref| apart."""
    got, ref = got.float(), ref.float()
    tol = 2 * float(_bf16_ulp(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert torch.isfinite(got).all() and err <= tol, (err, tol)


@pytest.mark.parametrize("b,t,h,d", [(2, 769, 16, 64), (3, 64, 4, 32),
                                     (1, 1, 2, 64), (2, 200, 8, 16)])
def test_k3_k4_match_plain(cuda, b, t, h, d):
    q, k, v = _qkv((b, t, h, d), seed=b * t + d)
    n3, n4 = att.oneshot_attention_packed.launches, att.oneshot_attention.launches
    packed = [x.reshape(b, t, h * d) for x in (q, k, v)]
    got3 = att.oneshot_attention_packed(*packed, h)
    ref3 = att.oneshot_attention_packed_plain(*packed, h)
    got4 = att.oneshot_attention(q, k, v)
    ref4 = att.oneshot_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert att.oneshot_attention_packed.launches == n3 + 1
    assert att.oneshot_attention.launches == n4 + 1
    assert got3.shape == (b, t, h * d) and got4.shape == (b, t, h, d)
    _assert_attention_close(got3, ref3)
    _assert_attention_close(got4, ref4)
    # one kernel: the two layouts give the same bits
    assert torch.equal(got3.reshape(b, t, h, d), got4)


@pytest.mark.parametrize("t,h,causal", [(3026, 6, False), (77, 12, True),
                                        (130, 4, True), (1000, 2, False)])
def test_k5_matches_plain(cuda, t, h, causal):
    q, k, v = _qkv((1, t, h, 64), seed=t)
    n5 = att.flash_attention_padded.launches
    got = att.flash_attention_padded(q, k, v, causal)
    ref = att.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert att.flash_attention_padded.launches == n5 + 1
    _assert_attention_close(got, ref)


def test_attention_keys_past_t_do_not_leak(cuda):
    """Inf and NaN in the storage right after the last key never reach
    the output (a batch-1 slice is contiguous, so the kernel gets it)."""
    b, t, h, d = 1, 70, 2, 64
    q, k, v = _qkv((b, 128, h, d), seed=9)
    k[:, t:] = float("inf")
    v[:, t:] = float("nan")
    q, k, v = (x[:, :t] for x in (q, k, v))
    assert k.is_contiguous()
    got = att.oneshot_attention(q, k, v)
    assert torch.isfinite(got.float()).all()
    _assert_attention_close(got, att.oneshot_attention_plain(q, k, v))


@pytest.mark.parametrize("b,t,h,d,causal", [(2, 769, 16, 64, False),
                                            (3, 77, 12, 64, True),
                                            (2, 200, 8, 16, False),
                                            (1, 130, 4, 32, True)])
def test_attention_float32_matches_plain(cuda, b, t, h, d, causal):
    """The float32 instance (CUDA cores, no TF32): within 1e-5 of max|ref|
    plus rtol 1e-4, the summation order and the online rescaling. K3 and
    K4 give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=cuda)
               for _ in range(3))
    if causal:
        got = att.flash_attention_padded(q, k, v, True)
        ref = att.flash_attention_plain(q, k, v, True)
    else:
        packed = [x.reshape(b, t, h * d) for x in (q, k, v)]
        got = att.oneshot_attention(q, k, v)
        got3 = att.oneshot_attention_packed(*packed, h)
        assert torch.equal(got3.reshape(b, t, h, d), got)
        ref = att.oneshot_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("name,overrides,hw", [
    ("tiny-test", {}, (48, 64)),
    ("ViT-L/14@336px", {"vision_layers": 2}, (336, 448))])
def test_default_dtype_vision_tower_on_the_card(cuda, name, overrides, hw):
    """``build_clip`` with its default dtype (float32) on the card runs
    the vision tower through the kernels (tiny-test: one head of 64 at
    T = 13 takes K4; ViT-L at T = 769 takes K3) and matches the same
    seeded tower on the CPU within 1e-4 of max|ref|."""
    from dropclip_tpu_torch.teachers.clip import build_clip

    towers = [build_clip(name, generator=torch.Generator().manual_seed(0),
                         device=dev, **overrides) for dev in ("cuda", "cpu")]
    px = torch.randn((2,) + hw + (3,), generator=torch.Generator()
                     .manual_seed(1))
    n = att.oneshot_attention.launches + att.oneshot_attention_packed.launches
    with torch.no_grad():
        for method in ("encode_image", "get_patch_encodings"):
            got = getattr(towers[0], method)(px.to(cuda)).cpu()
            ref = getattr(towers[1], method)(px)
            assert got.dtype == torch.float32 and got.shape == ref.shape
            assert float((got - ref).abs().max()) <= 1e-4 * float(
                ref.abs().max())
    assert (att.oneshot_attention.launches
            + att.oneshot_attention_packed.launches) > n


def test_attention_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        att.oneshot_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        att.oneshot_attention(q, q.bfloat16(), q)
    qb = q.bfloat16()
    with pytest.raises(ValueError):
        att.oneshot_attention(qb, qb, qb[:, :4].contiguous())
    with pytest.raises(ValueError):
        att.oneshot_attention_packed(*[torch.zeros(
            (1, 8, 2 * 48), device=cuda, dtype=torch.bfloat16)] * 3, 2)


@pytest.mark.parametrize("rows,c", [(96 * 769, 1024), (769, 1024), (3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_matches_plain(cuda, rows, c, dtype):
    """The sum is bit-equal (one rounding of the float32 sum to the
    stream dtype). y in float32: rtol 1e-5, atol 1e-5 (reduction order).
    y in bf16: one bf16 ulp of the plain result, the ulp taken at no less
    than 2^-10: the float32 statistics differ by reduction order, about
    1e-6 absolute after ``* scale + bias``, which is more than a bf16 ulp
    only where y cancels to below 2^-13 (seen once in 75M rows)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    r = (torch.randn((rows, c), generator=gen, device=cuda) * 3).to(dtype)
    dl = torch.randn((rows, c), generator=gen, device=cuda).to(dtype)
    s = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    b = 0.1 * torch.randn(c, generator=gen, device=cuda)
    before = add_layer_norm.launches
    got_s, got_y = add_layer_norm(r, dl, s, b)
    ref_s, ref_y = add_layer_norm_plain(r, dl, s, b)
    torch.cuda.synchronize()
    assert add_layer_norm.launches == before + 1
    assert torch.equal(got_s, ref_s)
    if dtype == torch.float32:
        torch.testing.assert_close(got_y, ref_y, rtol=1e-5, atol=1e-5)
    else:
        ref = ref_y.float()
        ulp = _bf16_ulp(ref.abs().clamp_min(2.0 ** -10))
        assert bool(((got_y.float() - ref).abs() <= ulp).all())


def _pillar_level(level, seed=0, z_shift=-5):
    """One level of a volumetric scene's pillar topology, on the card."""
    coords, mask = make_volumetric_coords(np.random.RandomState(seed), 1,
                                          2048, n_occ=1500, ext=12, zext=24)
    coords = coords[0] + np.array([0, 0, z_shift], np.int32) * mask[0, :,
                                                                    None]
    return build_pillar_topology(coords, mask[0], device="cuda"
                                 ).levels[level]


def _k2_args(lv, c, cout, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p, z = lv.occ.shape
    x = (torch.randn((p, z, c), generator=gen, device="cuda")
         * lv.occ[..., None]).to(dtype)
    w = (torch.randn((9, 3, c, cout), generator=gen, device="cuda")
         * (2.0 / (27 * cout)) ** 0.5).to(dtype)
    scale = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    return [x, lv.nbr9, w, lv.occ, scale, bias]


def _k2_close(got, ref, dtype):
    """float32 (TF32 off): rtol 1e-4 plus atol 1e-4 * max|ref|, the
    summation order of 27*C terms; bf16 inputs with f32 accumulation:
    1e-2 of max|ref| (one bf16 rounding of the output)."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    assert scale > 0
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float((got - ref).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("level,c,cout", [(0, 416, 384), (0, 3, 200),
                                          (1, 32, 32), (2, 24, 40),
                                          (3, 256, 256)])
@pytest.mark.parametrize("relu", [True, False])
def test_k2_matches_plain(cuda, level, c, cout, relu):
    """A volumetric scene whose z range starts off the 16-voxel lattice,
    asymmetric random weights, random scale and bias: every Z the levels
    give (32 down to 4), float32 and bf16."""
    lv = _pillar_level(level)
    for dtype in (torch.float32, torch.bfloat16):
        args = _k2_args(lv, c, cout, dtype, seed=level * 7 + c)
        before = pillar_conv3.launches
        got = pillar_conv3(*args, relu=relu)
        ref = pillar_conv3_plain(*args, relu=relu)
        torch.cuda.synchronize()
        assert pillar_conv3.launches == before + 1 and got.dtype == dtype
        _k2_close(got, ref, dtype)


@pytest.mark.parametrize("z", [1, 5, 24, 40])
def test_k2_random_occupancy_and_odd_z(cuda, z):
    """occ drawn at random (the kernel computes exactly the slots it is
    given), features not masked, Z not a multiple of 8."""
    gen = torch.Generator(device="cuda").manual_seed(z)
    p, c, cout = 37, 20, 136
    x = torch.randn((p, z, c), generator=gen, device=cuda)
    nbr = torch.randint(-2, p + 3, (p, 9), generator=gen, device=cuda,
                        dtype=torch.int32)
    nbr[:, 4] = torch.arange(p, device=cuda, dtype=torch.int32)
    occ = torch.rand((p, z), generator=gen, device=cuda) < 0.4
    w = torch.randn((9, 3, c, cout), generator=gen, device=cuda) * 0.1
    s = torch.rand(cout, generator=gen, device=cuda) + 0.5
    b = torch.randn(cout, generator=gen, device=cuda) * 0.1
    got = pillar_conv3(x, nbr, w, occ, s, b, relu=True)
    ref = pillar_conv3_plain(x, nbr, w, occ, s, b, relu=True)
    _k2_close(got, ref, torch.float32)
    assert bool((got[~occ] == 0).all())


def test_k2_z_ends_and_misses_read_zeros(cuda):
    """z - 1 at z = 0 is not the previous pillar's last slot, and rows
    outside [0, P) are never read: a column whose neighbours are all
    misses equals the centre column's three z taps alone."""
    p, z, c, cout = 6, 8, 16, 8
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((p, z, c), generator=gen, device=cuda) + 3.0
    w = torch.randn((9, 3, c, cout), generator=gen, device=cuda)
    nbr = torch.full((p, 9), p, device=cuda, dtype=torch.int32)
    nbr[:, 4] = torch.arange(p, device=cuda, dtype=torch.int32)
    nbr[1, :4] = -1
    nbr[2, 5:] = 2 ** 30
    occ = torch.ones((p, z), dtype=torch.bool, device=cuda)
    ones, zeros = torch.ones(cout, device=cuda), torch.zeros(cout,
                                                             device=cuda)
    got = pillar_conv3(x, nbr, w, occ, ones, zeros, relu=False)
    up = torch.nn.functional.pad(x[:, :-1], (0, 0, 1, 0))
    dn = torch.nn.functional.pad(x[:, 1:], (0, 0, 0, 1))
    ref = up @ w[4, 0] + x @ w[4, 1] + dn @ w[4, 2]
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_k2_limit_sees_swapped_z_taps(cuda):
    """A planted fault, the dz = -1 and dz = +1 taps swapped, fails the
    limits that the kernel passes."""
    lv = _pillar_level(0)
    for dtype in (torch.float32, torch.bfloat16):
        args = _k2_args(lv, 64, 64, dtype, seed=11)
        ref = pillar_conv3_plain(*args, relu=False)
        _k2_close(pillar_conv3(*args, relu=False), ref, dtype)
        bad = list(args)
        bad[2] = args[2].flip(1).contiguous()
        with pytest.raises(AssertionError):
            _k2_close(pillar_conv3(*bad, relu=False), ref, dtype)


def test_k2_wrapper_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((4, 8, 16), device=cuda)
    nbr = torch.zeros((4, 9), dtype=torch.int32, device=cuda)
    w = torch.zeros((9, 3, 16, 8), device=cuda)
    occ = torch.ones((4, 8), dtype=torch.bool, device=cuda)
    s, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        pillar_conv3(x.half(), nbr, w.half(), occ, s, b)
    with pytest.raises(ValueError):
        pillar_conv3(x, nbr.cpu(), w, occ, s, b)
    with pytest.raises(ValueError):
        pillar_conv3(x.transpose(0, 1).contiguous().transpose(0, 1), nbr,
                     w, occ, s, b)


def test_pillar_student_on_the_card_matches_cpu(cuda):
    """The tiny pillar student on the card runs K2 16 times per forward
    and matches the same weights on the CPU within 1e-4 of max|ref|."""
    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.sparse.unet_pillars import build_student_pillars

    coords, mask = make_volumetric_coords(np.random.RandomState(3), 1, 1024,
                                          n_occ=700, ext=10, zext=20)
    cfg = CfgNode(dict(arch_3d="tiny", feat_dim=16, use_color=True))
    feats = torch.randn((1024, 6), generator=torch.Generator().manual_seed(
        0)) * torch.as_tensor(mask[0])[:, None]
    outs = []
    for dev in ("cuda", "cpu"):
        model = build_student_pillars(
            cfg, generator=torch.Generator().manual_seed(1)).to(dev)
        topo = build_pillar_topology(coords[0], mask[0], device=dev)
        before = pillar_conv3.launches
        with torch.no_grad():
            outs.append(model(topo, feats.to(dev)).cpu())
        assert pillar_conv3.launches - before == (16 if dev == "cuda" else 0)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4 * float(
        outs[1].abs().max())
