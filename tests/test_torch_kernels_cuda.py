"""The port's hand-written kernels against their plain PyTorch versions on
the card: K1 (``kernels/brick_conv3.py``, CUDA C++), K2
(``kernels/pillar_conv3.py``, CUDA C++), K3, K4 and K5
(``ops/attention.py`` over ``csrc/attention.cu``, CUDA C++), and K6 and K7
(``ops/layernorm.py``, Triton); and the raw-data slice's torch ops on the
card against their CPU results (``grasp.rank_grasps_by_query``,
``geom.knn.nearest_neighbor_device``, ``geom.voxelize.sparse_quantize``).

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
                                                    brick_conv3_plain,
                                                    instance, row_order)
from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count
from dropclip_tpu_torch.kernels.pillar_conv3 import (_scratch, pillar_conv3,
                                                     pillar_conv3_plain)
from dropclip_tpu_torch.kernels.pillar_conv3 import \
    row_order as pillar_row_order
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
    before = k1_count.launches
    got = brick_conv3(x, lv.nbr, w, lv.occ)
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ)
    torch.cuda.synchronize()
    assert k1_count.launches == before + 1
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


def test_k1_float32_wide_magnitudes(cuda):
    """3xTF32 keeps float32 accuracy where 1xTF32 would not: features and
    weights whose magnitudes span 1e-3 to 1e3 (log-uniform, random sign)
    at the widest main-path conv, to the float32 limit (rtol 1e-4, atol
    1e-4 * max|ref|)."""
    lv = _folded_level((4, 4, 2), level=0)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def spread(shape):
        mag = 10.0 ** (torch.rand(shape, generator=gen, device=cuda) * 6 - 3)
        return mag * torch.randn(shape, generator=gen, device=cuda).sign()

    c, cout = 416, 384
    x = spread(tuple(lv.occ.shape) + (c,)) * lv.occ[..., None]
    w = spread((27, c, cout)) * 1e-3
    got = brick_conv3(x, lv.nbr, w, lv.occ)
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("upper", ["zero", "unoccupied", "occupied"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_skips_taps_no_row_reads(cuda, dtype, upper):
    """Isolated (4, 4, 2) bricks (every neighbour a miss) occupied in the
    z = 0 layer only: no row has a source at a dz = -1 tap, and the dz =
    +1 taps read the z = 1 layer, which holds zeros ("zero"; the kernel
    skips 18 of 27 taps), nonzero features off the occupied voxels
    ("unoccupied"; live sources, so nothing is skipped there) or occupied
    voxels ("occupied"). Each equals the plain version to K1's limits;
    all-zero features give zeros."""
    bm, c, cout = 300, 64, 96
    gen = torch.Generator(device="cuda").manual_seed(4)
    nbr = torch.full((bm, 27), -1, dtype=torch.int32, device=cuda)
    nbr[:, 13] = torch.arange(bm, dtype=torch.int32, device=cuda)
    occ = torch.zeros((bm, 4, 4, 2), dtype=torch.bool, device=cuda)
    occ[..., 0] = torch.rand((bm, 4, 4), generator=gen, device=cuda) > 0.4
    if upper == "occupied":
        occ[..., 1] = torch.rand((bm, 4, 4), generator=gen,
                                 device=cuda) > 0.7
    x = torch.randn((bm, 4, 4, 2, c), generator=gen, device=cuda)
    if upper == "zero":
        x[..., 1, :] = 0
    x = x * (occ[..., None] | (upper == "unoccupied"))
    x = x.to(dtype)
    w = (torch.randn((27, c, cout), generator=gen, device=cuda)
         * 0.1).to(dtype)
    got = brick_conv3(x, nbr, w, occ).float()
    ref = brick_conv3_plain(x, nbr, w, occ).float()
    scale = float(ref.abs().max())
    assert scale > 0
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float((got - ref).abs().max()) <= 1e-2 * scale
    zeros = brick_conv3(torch.zeros_like(x), nbr, w, occ)
    assert not bool(zeros.any())


def test_k1_float32_long_sums_do_not_drift(cuda):
    """All-positive features and weights at the widest main-path conv
    (416 -> 384, 11232 products per output): the tensor cores truncate as
    they accumulate, and over one mma chain as long as K that bias adds
    up to about 2e-4 of each sum, outside the float32 limit (rtol 1e-4,
    atol 1e-4 * max|ref|); K1 adds each step's short chain in
    round-to-nearest float32 and stays inside it."""
    lv = _folded_level((4, 4, 2), level=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    c, cout = 416, 384
    x = torch.rand(tuple(lv.occ.shape) + (c,), generator=gen,
                   device=cuda) * lv.occ[..., None]
    w = torch.rand((27, c, cout), generator=gen, device=cuda) / (27 * c)
    got = brick_conv3(x, lv.nbr, w, lv.occ)
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_shared_schedule_matches_plain(cuda, dtype):
    """The level's ``row_order`` passed in, as the student shares it, on
    features that vanish off ``occ``: the same result as the plain version
    to K1's limits; a schedule of another shape raises."""
    lv = _folded_level((4, 4, 2), level=1)
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (torch.randn(tuple(lv.occ.shape) + (64,), generator=gen,
                     device=cuda) * lv.occ[..., None]).to(dtype)
    w = (torch.randn((27, 64, 128), generator=gen, device=cuda)
         * 0.05).to(dtype)
    sched = row_order(lv.occ, lv.nbr)
    got = brick_conv3(x, lv.nbr, w, lv.occ, sched).float()
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ).float()
    scale = float(ref.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert float((got - ref).abs().max()) <= 1e-2 * scale
    with pytest.raises(ValueError):
        brick_conv3(x, lv.nbr, w, lv.occ, (sched[0][1:],) + sched[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_brick_student_keeps_the_schedule_contract(cuda, dtype, monkeypatch):
    """MinkUNet14D at full width on the card: the forward with each level's
    shared row schedule (``unet_bricks.level_schedule``) gives exactly the
    output of the same forward with ``schedule=None`` in every K1 call,
    where the wrapper takes liveness from the features. A student whose
    conv inputs did not vanish off ``occ`` would differ."""
    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.distill.engine import (build_student_for,
                                                   build_topology)
    from dropclip_tpu_torch.sparse import unet_bricks

    coords, mask = make_tabletop_coords(np.random.RandomState(4), 2, 2048,
                                        n_occ=1600, ext=24)
    caps = bricks.autotune_brick_capacities(coords, mask,
                                            brick_shape=(4, 4, 2))
    cfg = CfgNode(dict(arch_3d="MinkUNet14D", feat_dim=64, use_color=True,
                       brick_shape=[4, 4, 2], brick_capacities=list(caps)))
    model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    topo = build_topology(cfg, torch.as_tensor(coords, device=cuda),
                          torch.as_tensor(mask, device=cuda))
    feats = (torch.randn((2, 2048, 6), generator=torch.Generator()
                         .manual_seed(3)) * torch.as_tensor(mask)[..., None])
    feats = feats.to(cuda, dtype)
    outs = []
    for shared in (True, False):
        if not shared:
            monkeypatch.setattr(unet_bricks, "level_schedule",
                                lambda level: None)
        before = k1_count.launches
        with torch.no_grad():
            outs.append(model(topo, feats))
        assert k1_count.launches - before == 16
    assert float(outs[0].float().abs().max()) > 0
    assert torch.equal(outs[0], outs[1])


# demangled kernel name parts of each instance
K1_KERNELS = {"tf32x3": ("brick_conv3_mma", "Tf32x3, true"),
              "tf32x3_ragged": ("brick_conv3_mma", "Tf32x3, false"),
              "bf16": ("brick_conv3_mma", "Bf16Wgmma, true"),
              "bf16_ragged": ("brick_conv3_mma", "Bf16Wgmma, false")}


@pytest.mark.parametrize("dtype,c,cout", [(torch.float32, 32, 64),
                                          (torch.float32, 3, 200),
                                          (torch.bfloat16, 32, 64),
                                          (torch.bfloat16, 3, 200)])
def test_k1_dtypes_reach_their_instance(cuda, dtype, c, cout):
    """The profiler names the kernel that ran, and it is the one that
    ``instance(dtype, C, Cout)`` picks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lv = _folded_level((4, 4, 2), level=1)
    gen = torch.Generator(device="cuda").manual_seed(c)
    x = (torch.randn(tuple(lv.occ.shape) + (c,), generator=gen,
                     device=cuda) * lv.occ[..., None]).to(dtype)
    w = torch.randn((27, c, cout), generator=gen, device=cuda).to(dtype)
    brick_conv3(x, lv.nbr, w, lv.occ)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        brick_conv3(x, lv.nbr, w, lv.occ)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "brick_conv3" in e.key]
    parts = K1_KERNELS[instance(dtype, c, cout)]
    assert names and all(all(p in n for p in parts) for n in names), names


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
                                    (3, 32), (769, 1024), (96, 1024),
                                    (308, 512), (16130, 384), (1025, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain(cuda, rows, c, dtype):
    """float32: rtol 1e-5, atol 1e-5 (reduction order); bf16 in/out: at
    most one bf16 ulp of the plain result, the ulp taken at no less than
    2^-10 above a million values (``chip_smoke.ln_close``'s rule: float32
    reduction order can flip a value that cancels below 2^-13). The
    1024-wide rows are the ViT-L teacher's (ln_pre and block 0's ln_1 over
    a crop's 769 tokens, ln_post over 96 class tokens); (308, 512) is
    RN50's text tower on 4 prompts (4 warps a row at so few rows), (16130,
    384) DINO v1's rows at 512x512 and (1025, 384) the fewest rows of the
    one-warp instance, its last program half empty."""
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
        floor = (2.0 ** -10 if rows * c > 10 ** 6
                 else torch.finfo(torch.float32).tiny)
        ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(floor)))
                      - 7)
        assert bool(((got.float() - ref).abs() <= ulp).all())


@pytest.mark.parametrize("rows", [3026, 16130, 3027])
def test_k6_at_dino_v1_rows(cuda, rows):
    """K6 at DINO v1 S/8's float32 rows of 384 (224x224 and 512x512 at
    stride 4) with its eps 1e-6, rtol 1e-5, atol 1e-5: a warp per row, two
    rows a program, and 3027 rows leave the last program half empty."""
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn((rows, 384), generator=gen, device=cuda) * 3
    s = 1 + 0.1 * torch.randn(384, generator=gen, device=cuda)
    b = 0.1 * torch.randn(384, generator=gen, device=cuda)
    before = layer_norm.launches
    got = layer_norm(x, s, b, eps=1e-6)
    ref = layer_norm_plain(x, s, b, eps=1e-6)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("mode", [0, 1])
def test_wgmma_descriptor_selftest(cuda, mode):
    """One 64x64x64 wgmma with v3's descriptors against the float32
    product (TF32 off): mode 0 K-major SS (S = Q K^T), mode 1 RS A with an
    MN-major B (O += P V). bf16 products are exact in float32; the sums
    differ in order only: within 1e-5 of max|ref|."""
    from dropclip_tpu_torch.kernels.attention import wgmma_selftest

    q, k, _ = _qkv((64, 64), seed=20 + mode)
    b = k if mode == 0 else k.T.contiguous()
    got = wgmma_selftest(q, b, mode)
    ref = q.float() @ k.float().T
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 769, 3073])
def test_v3_matches_plain(cuda, t, causal):
    """v3 (bf16, D = 64) at T on and off the 64-row tiles: packed (K3) and
    per-head (K4) non-causal, K5 causal or not, each within the bf16
    limit of its plain version."""
    from dropclip_tpu_torch.kernels.attention import instance

    assert instance(torch.bfloat16, 64) == "v3"
    b, h = 2, 4
    q, k, v = _qkv((b, t, h, 64), seed=t + causal)
    got = att.flash_attention_padded(q, k, v, causal)
    _assert_attention_close(got, att.flash_attention_plain(q, k, v, causal))
    if not causal:
        packed = [x.reshape(b, t, h * 64) for x in (q, k, v)]
        got3 = att.oneshot_attention_packed(*packed, h)
        _assert_attention_close(got3, att.oneshot_attention_packed_plain(
            *packed, h))
        got4 = att.oneshot_attention(q, k, v)
        _assert_attention_close(got4, att.oneshot_attention_plain(q, k, v))
        assert torch.equal(got3.reshape(b, t, h, 64), got4)


@pytest.mark.parametrize("t,causal", [(1, False), (65, True), (769, False)])
def test_v3_keys_past_t_do_not_leak(cuda, t, causal):
    """The leak test on v3 at T where the last key tile is ragged: Inf and
    NaN right after the last key never reach the output."""
    b, h, d = 1, 2, 64
    q, k, v = _qkv((b, t + 64, h, d), seed=t + 1)
    k[:, t:] = float("inf")
    v[:, t:] = float("nan")
    q, k, v = (x[:, :t] for x in (q, k, v))
    got = att.flash_attention_padded(q, k, v, causal)
    assert torch.isfinite(got.float()).all()
    _assert_attention_close(got, att.flash_attention_plain(q, k, v, causal))


@pytest.mark.parametrize("b,t,causal", [(96, 337, False), (2, 1, False),
                                        (2, 97, False), (1, 769, False),
                                        (3, 65, True), (2, 337, True)])
def test_d80_matches_plain(cuda, b, t, causal):
    """The bf16 instance at D = 80 (OpenCLIP ViT-H/14's 16 heads of 80) at
    the ingest's (96, 337) and at odd T, through K4 (the route of its
    heads) and K3 non-causal, K5 causal: each within the bf16 limit of its
    plain version, K3 and K4 the same bits, one d80 launch each."""
    from dropclip_tpu_torch.kernels.attention import counters, instance

    assert instance(torch.bfloat16, 80) == "d80"
    h, d = 16, 80
    q, k, v = _qkv((b, t, h, d), seed=t + causal)
    n = counters["d80"].launches
    if causal:
        got = att.flash_attention_padded(q, k, v, True)
        torch.cuda.synchronize()
        _assert_attention_close(got, att.flash_attention_plain(q, k, v,
                                                               True))
        assert counters["d80"].launches == n + 1
        return
    got4 = att.oneshot_attention(q, k, v)
    packed = [x.reshape(b, t, h * d) for x in (q, k, v)]
    got3 = att.oneshot_attention_packed(*packed, h)
    torch.cuda.synchronize()
    assert counters["d80"].launches == n + 2
    _assert_attention_close(got4, att.oneshot_attention_plain(q, k, v))
    assert torch.equal(got3.reshape(b, t, h, d), got4)


@pytest.mark.parametrize("t,causal", [(1, False), (65, True), (337, False)])
def test_d80_keys_past_t_do_not_leak(cuda, t, causal):
    """The leak test on d80: Inf and NaN right after the last key never
    reach the output."""
    b, h, d = 1, 2, 80
    q, k, v = _qkv((b, t + 64, h, d), seed=t + 2)
    k[:, t:] = float("inf")
    v[:, t:] = float("nan")
    q, k, v = (x[:, :t] for x in (q, k, v))
    got = att.flash_attention_padded(q, k, v, causal)
    assert torch.isfinite(got.float()).all()
    _assert_attention_close(got, att.flash_attention_plain(q, k, v, causal))


def test_vit_h14_blocks_on_the_card(cuda):
    """ViT-H/14 at its published widths (1280, 16 heads of 80, exact
    GELU), cut to two blocks, in bf16 on the card (K4 at d80, K6, K7)
    against the same tower on the CPU in float32: class-token and patch
    features within 2% of each row's norm, the bf16 rounding; the text
    tower too (1024, 16 heads of 64, two blocks)."""
    from dropclip_tpu_torch.kernels.attention import counters
    from dropclip_tpu_torch.teachers.clip import build_clip

    kw = dict(vision_layers=2, transformer_layers=2)
    card = build_clip("ViT-H-14", dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator().manual_seed(0), **kw)
    cpu = build_clip("ViT-H-14", device="cpu",
                     generator=torch.Generator().manual_seed(0), **kw)
    px = torch.randn((4, 224, 294, 3), generator=torch.Generator()
                     .manual_seed(1))
    tok = torch.randint(1, 49000, (3, 77), generator=torch.Generator()
                        .manual_seed(2))
    tok[:, 9] = 49407
    n = counters["d80"].launches
    with torch.no_grad():
        for method, x in (("encode_image", px), ("get_patch_encodings", px),
                          ("encode_text", tok)):
            got = getattr(card, method)(x.to(cuda)).float().cpu()
            ref = getattr(cpu, method)(x)
            gap = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
            assert float(gap.max()) < 0.02, (method, float(gap.max()))
    # two blocks in each vision forward; the patch path's last block runs
    # its value path alone
    assert counters["d80"].launches == n + 3


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 80, "attention_kernel_d80"),
    (torch.bfloat16, 64, "attention_kernel_v3"),
    (torch.bfloat16, 16, "attention_kernel<16>"),
    (torch.bfloat16, 32, "attention_kernel<32>"),
    (torch.float32, 64, "attention_kernel_f32x3_wgmma"),
    (torch.float32, 16, "attention_kernel_f32x3<16>")])
def test_attention_shapes_reach_their_instance(cuda, dtype, d, kernel):
    """The profiler names the kernel that ran: v3 for bf16 at D = 64, v2
    for bf16 at D = 16 and 32, the 3xTF32 instance for float32."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn((2, 100, 4, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    att.oneshot_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            att.oneshot_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    ran = [n for n in names if "attention_kernel" in n]
    assert ran and all(kernel in n for n in ran), names


@pytest.mark.parametrize("b,t,h,d,causal", [(2, 769, 16, 64, False),
                                            (3, 77, 12, 64, True),
                                            (2, 200, 8, 16, False),
                                            (1, 130, 4, 32, True)])
def test_attention_float32_matches_plain(cuda, b, t, h, d, causal):
    """The float32 instance (3xTF32 against the plain version with TF32
    off): within 1e-5 of max|ref| plus rtol 1e-4, the summation order, the
    split's 21 bits and the online rescaling. K3 and K4 give the same
    bits."""
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


@pytest.mark.parametrize("rows,c", [(96 * 769, 1024), (769, 1024), (3, 64),
                                    (3026, 384)])
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
    up = torch.nn.functional.pad(x[:, :-1], (0, 0, 1, 0))
    dn = torch.nn.functional.pad(x[:, 1:], (0, 0, 0, 1))
    ref = up @ w[4, 0] + x @ w[4, 1] + dn @ w[4, 2]
    # with a unit scale and zero bias, and without an affine step
    for affine in ((ones, zeros), ()):
        got = pillar_conv3(x, nbr, w, occ, *affine, relu=False)
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
    order, n_occ = pillar_row_order(occ)
    with pytest.raises(ValueError):
        pillar_conv3(x, nbr, w, occ, s, b, schedule=(order[1:], n_occ))
    with pytest.raises(ValueError):
        pillar_conv3(x, nbr, w, occ, s, b, schedule=(order.cpu(), n_occ))


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


def _serve_level(level):
    """A level of a volumetric scene at chip_smoke.py's size (6000 voxels,
    z0 80): level 0 at Cout 384 gives 141 tiles (47 rows of tiles), just
    over one float32 wave of 132 SMs."""
    coords, mask = make_volumetric_coords(np.random.RandomState(8), 1, 8192,
                                          n_occ=6000, ext=20, zext=32)
    return build_pillar_topology(coords[0], mask[0], z0=80,
                                 device="cuda").levels[level]


def _k2_split(lv, c, cout, dtype):
    """Whether K2 splits K at this level, by the kernel's rule
    (``csrc/pillar_conv3.cu``): only tiles that fit the scratch split;
    float32 (one block per SM) takes the tap groups whose items finish
    soonest (``tap_groups``), bf16 (two per SM) as many as fill its grid
    once."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_tiles = -(-int(lv.occ.sum()) // 128) * -(-cout // 128)
    if n_tiles > 2 * n_sm:
        return False
    if dtype == torch.bfloat16:
        return 2 * n_sm // n_tiles >= 2
    chunks = -(-c // 32)
    cost = [-(-n_tiles * g // n_sm) * (-(-27 // g) * chunks
                                        + (5 if g > 1 else 2))
            for g in range(1, 28)]
    return cost.index(min(cost)) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_shared_schedule_matches_none(cuda, dtype):
    """The level's ``row_order`` passed in, as the student shares it:
    exactly K2's result without one where K is not split, and both within
    K2's limits of the plain version where it is (their float32 atomics
    add in another order each run)."""
    for level, c, cout in ((0, 64, 1024), (0, 416, 384), (3, 256, 256)):
        lv = _serve_level(level)
        split = _k2_split(lv, c, cout, dtype)
        assert split == (level == 3 or dtype == torch.float32 and cout == 384)
        args = _k2_args(lv, c, cout, dtype, seed=21 + level)
        shared = pillar_conv3(*args, relu=True,
                              schedule=pillar_row_order(lv.occ))
        none = pillar_conv3(*args, relu=True)
        ref = pillar_conv3_plain(*args, relu=True)
        torch.cuda.synchronize()
        if not split:
            assert torch.equal(shared, none)
        _k2_close(shared, ref, dtype)
        _k2_close(none, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level,c,cout", [(4, 384, 384), (3, 256, 256),
                                          (2, 32, 64), (1, 20, 136)])
def test_k2_split_path_matches_plain(cuda, dtype, level, c, cout):
    """The deep levels (few rows, K up to 27 * 384) split K into tap
    groups whose sums meet in the scratch: the result is within K2's
    limits, one launch, and the scratch and its counts are zero again."""
    lv = _serve_level(level)
    assert _k2_split(lv, c, cout, dtype)
    args = _k2_args(lv, c, cout, dtype, seed=31 + level)
    before = pillar_conv3.launches
    got = pillar_conv3(*args, relu=level % 2 == 0)
    ref = pillar_conv3_plain(*args, relu=level % 2 == 0)
    torch.cuda.synchronize()
    assert pillar_conv3.launches == before + 1
    _k2_close(got, ref, dtype)
    sums, counts, _ = _scratch(got.device,
                               torch.cuda.current_stream().cuda_stream)
    assert not bool(sums.any()) and not bool(counts.any())


# demangled kernel name parts of each instance
K2_KERNELS = {"tf32x3": ("pillar_conv3_mma", "Tf32x3, true"),
              "tf32x3_ragged": ("pillar_conv3_mma", "Tf32x3, false"),
              "bf16": ("pillar_conv3_mma", "Bf16Wgmma, true"),
              "bf16_ragged": ("pillar_conv3_mma", "Bf16Wgmma, false")}


K2_ONE_LAUNCH_CASES = [(level, dtype, c, cout) for level in (0, 3)
                       for dtype, c, cout in (("float32", 64, 128),
                                              ("float32", 3, 200),
                                              ("bfloat16", 64, 128),
                                              ("bfloat16", 3, 200))]


def _k2_kernels_of_one_call():
    """For each case of K2_ONE_LAUNCH_CASES: the instance ``instance``
    picks and the (name, count) of every kernel the profiler saw on the
    card during one K2 call given the level's schedule. Run in a fresh
    process: in a pytest process that had run other tests on the card,
    sessions this short often recorded no kernel at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dropclip_tpu_torch.kernels.pillar_conv3 import instance as k2_inst

    seen = {}
    for level, dtype_name, c, cout in K2_ONE_LAUNCH_CASES:
        dtype = getattr(torch, dtype_name)
        lv = _serve_level(level)
        args = _k2_args(lv, c, cout, dtype, seed=c + level)
        sched = pillar_row_order(lv.occ)
        pillar_conv3(*args, schedule=sched)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pillar_conv3(*args, schedule=sched)
            torch.cuda.synchronize()
        seen[(level, dtype_name, c, cout)] = (
            k2_inst(dtype, c, cout),
            [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA])
    return seen


@pytest.fixture(scope="module")
def k2_one_call_kernels():
    import multiprocessing

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(_k2_kernels_of_one_call)


@pytest.mark.parametrize("case", K2_ONE_LAUNCH_CASES)
def test_k2_one_launch_of_its_instance(cuda, k2_one_call_kernels, case):
    """With the level's schedule given, a K2 call is one kernel launch on
    the card and nothing else (no sort, no memset, no second pass), split
    (level 3) or not; the profiler names that kernel, and it is the
    instance that ``instance(dtype, C, Cout)`` picks."""
    picked, kernels = k2_one_call_kernels[case]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert all(p in kernels[0][0] for p in K2_KERNELS[picked]), kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pillar_student_keeps_the_schedule_contract(cuda, dtype,
                                                    monkeypatch):
    """MinkUNet14D on the pillar engine on the card: the forward with each
    level's shared row schedule (``unet_pillars.level_schedule``) gives the
    output of the same forward with ``schedule=None`` in every K2 call, 16
    launches each, within K2's limits (the split levels' atomics add in
    another order each run)."""
    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.sparse import unet_pillars

    coords, mask = make_volumetric_coords(np.random.RandomState(4), 1, 2048,
                                          n_occ=1600, ext=12, zext=24)
    cfg = CfgNode(dict(arch_3d="MinkUNet14D", feat_dim=64, use_color=True))
    model = unet_pillars.build_student_pillars(
        cfg, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    topo = build_pillar_topology(coords[0], mask[0], device=cuda)
    feats = (torch.randn((2048, 6), generator=torch.Generator()
                         .manual_seed(3)) * torch.as_tensor(mask[0])[:, None])
    feats = feats.to(cuda, dtype)
    outs = []
    for shared in (True, False):
        if not shared:
            monkeypatch.setattr(unet_pillars, "level_schedule",
                                lambda level: None)
        before = pillar_conv3.launches
        with torch.no_grad():
            outs.append(model(topo, feats))
        assert pillar_conv3.launches - before == 16
    _k2_close(outs[0], outs[1], dtype)


# ------------------------------------------------- K1 under autograd (train)

def _student_level(level):
    """A folded level of two tabletop scenes at the trainer's size (6000
    voxels each, 8192-voxel capacity, (4, 4, 2) bricks, capacities
    autotuned with slack 1.5)."""
    coords, mask = make_tabletop_coords(np.random.RandomState(11), 2, 8192,
                                        n_occ=6000, ext=40)
    caps = bricks.autotune_brick_capacities(coords, mask, slack=1.5,
                                            brick_shape=(4, 4, 2))
    topo = bricks.build_brick_topology(
        torch.as_tensor(coords, device="cuda"),
        torch.as_tensor(mask, device="cuda"), brick_capacities=caps,
        brick_shape=(4, 4, 2))
    return bricks.fold_topology(topo).levels[level]


def _fn_grads(lv, x_raw, w, dy, plain):
    """(dX_raw, dW) of sum(conv(x_raw * occ, w) * dy): BrickConv3Fn with
    the level's schedule, or native autograd of the plain version."""
    from dropclip_tpu_torch.kernels.brick_conv3 import BrickConv3Fn

    x_raw = x_raw.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    x = x_raw * lv.occ[..., None].to(x_raw.dtype)
    if plain:
        out = brick_conv3_plain(x, lv.nbr, w, lv.occ)
    else:
        out = BrickConv3Fn.apply(x, w, lv.nbr, lv.occ,
                                 row_order(lv.occ, lv.nbr))
    (out.float() * dy).sum().backward()
    return x_raw.grad.float(), w.grad.float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level,c,cout", [(0, 416, 384), (1, 32, 32),
                                          (2, 448, 384), (4, 256, 256)])
def test_k1_backward_matches_plain_autograd(cuda, dtype, level, c, cout):
    """BrickConv3Fn on the card (K1 forward and K1 dgrad: two launches;
    wgrad gathered products) against native autograd of the plain conv on
    masked inputs, at MinkUNet14D's level shapes: float32 (TF32 off)
    1e-4 of max|ref| plus rtol 1e-4, bf16 1e-2 of max|ref|; the planted
    fault, dgrad taps transposed but not mirrored, reads past 10x the
    dtype's limit of max|ref|."""
    from dropclip_tpu_torch.kernels import brick_conv3 as k1

    lv = _student_level(level)
    gen = torch.Generator(device="cuda").manual_seed(40 + level)
    x = torch.randn(tuple(lv.occ.shape) + (c,), generator=gen,
                    device=cuda).to(dtype)
    w = (torch.randn((27, c, cout), generator=gen, device=cuda)
         * (2.0 / (27 * cout)) ** 0.5).to(dtype)
    dy = torch.randn(tuple(lv.occ.shape) + (cout,), generator=gen,
                     device=cuda)
    before = k1_count.launches
    got = _fn_grads(lv, x, w, dy, plain=False)
    assert k1_count.launches - before == 2
    ref = _fn_grads(lv, x, w, dy, plain=True)
    torch.cuda.synchronize()
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    for g, r in zip(got, ref):
        scale = float(r.abs().max())
        assert scale > 0
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * scale)
        else:
            assert float((g - r).abs().max()) <= limit * scale
    k1_mirror = k1.mirror_taps
    try:
        k1.mirror_taps = lambda t: t.transpose(1, 2).contiguous()
        bad = _fn_grads(lv, x, w, dy, plain=False)[0]
    finally:
        k1.mirror_taps = k1_mirror
    assert float((bad - ref[0]).abs().max()) > 10 * limit * float(
        ref[0].abs().max())


def test_k5_float32_at_dino_v1_512_matches_plain(cuda):
    """K5's float32 instance at DINO v1 ViT-S/8, stride 4, on a 512x512
    input: (1, 16130, 6, 64), the longest sequence the teachers give it.
    Within 1e-5 of max|ref| plus rtol 1e-4, as the float32 instance's
    other cases."""
    gen = torch.Generator(device="cuda").manual_seed(16130)
    q, k, v = (torch.randn((1, 16130, 6, 64), generator=gen, device=cuda)
               for _ in range(3))
    n5 = att.flash_attention_padded.launches
    got = att.flash_attention_padded(q, k, v)
    ref = att.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert att.flash_attention_padded.launches == n5 + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("t", [3026, 4016])
def test_k5_float32_at_dino_v1_matches_plain(cuda, t):
    """K5's float32 instance at DINO v1 ViT-S/8's rows, stride 4: T = 3026
    (224x224) and T = 4016 (``dino_extract`` at a short side of 224 on
    480x640 frames), both ragged against the 64-key tiles. Within 1e-5 of
    max|ref| plus rtol 1e-4."""
    gen = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn((1, t, 6, 64), generator=gen, device=cuda)
               for _ in range(3))
    n5 = att.flash_attention_padded.launches
    got = att.flash_attention_padded(q, k, v)
    ref = att.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert att.flash_attention_padded.launches == n5 + 1
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))


def test_k5_float32_wide_magnitudes(cuda):
    """3xTF32 keeps float32 accuracy where 1xTF32 would not: logits of
    spread 4 and values whose magnitudes span 1e-2 to 1e2 (log-uniform,
    random sign) at DINO v1's heads. The kernel stays within the float32
    limit (rtol 1e-4, atol 1e-5 * max|ref|); the plain version with its
    products in TF32 (one rounding of each operand) leaves it."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (1, 1000, 6, 64)
    q, k = (2 * torch.randn(shape, generator=gen, device=cuda)
            for _ in range(2))
    mag = 10.0 ** (torch.rand(shape, generator=gen, device=cuda) * 4 - 2)
    v = mag * torch.randn(shape, generator=gen, device=cuda).sign()
    got = att.flash_attention_padded(q, k, v)
    ref = att.flash_attention_plain(q, k, v)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = att.flash_attention_plain(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    atol = 1e-5 * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=atol)
    assert not torch.allclose(tf32, ref, rtol=1e-4, atol=atol)


def test_k4_at_dinov2_518_matches_plain(cuda):
    """K4 at DINOv2-L/14 on 518x518 frames, 8 at a time: (8, 1370, 16, 64)
    bf16, within 2 bf16 ulps of max|ref|."""
    q, k, v = _qkv((8, 1370, 16, 64), seed=1370)
    n4 = att.oneshot_attention.launches
    got = att.oneshot_attention(q, k, v)
    ref = att.oneshot_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert att.oneshot_attention.launches == n4 + 1
    _assert_attention_close(got, ref)


def test_rank_grasps_by_query_card_matches_cpu(cuda):
    """The language-ranked grasp scores on the card within 1e-5 of
    max|score| of the CPU's, on the same float32 inputs, and the order
    equal wherever neighbouring scores are more than that apart."""
    from dropclip_tpu_torch.grasp.grasps import rank_grasps_by_query

    rng = np.random.default_rng(0)
    n, g, c = 8000, 32, 768
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    args = dict(
        points=rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        point_feats=rng.standard_normal((n, c)).astype(np.float32),
        point_mask=rng.random(n) > 0.05,
        grasp_positions=rng.uniform(-0.3, 0.3, (g, 3)).astype(np.float32),
        grasp_scores=rng.random(g).astype(np.float32),
        pos_emb=unit(rng.standard_normal(c)).astype(np.float32),
        neg_embs=unit(rng.standard_normal((4, c))).astype(np.float32))
    ref_order, ref = rank_grasps_by_query(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in args.items()})
    order, got = rank_grasps_by_query(
        **{k: torch.from_numpy(np.asarray(v)).to(cuda)
           for k, v in args.items()})
    assert got.device.type == "cuda"
    tol = 1e-5 * float(ref.abs().max())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=tol)
    ranked = ref[ref_order]
    gaps = (ranked[1:] - ranked[:-1]) < -tol
    clear = torch.ones(g, dtype=torch.bool)
    clear[1:] &= gaps
    clear[:-1] &= gaps
    assert torch.equal(order.cpu()[clear], ref_order[clear])


def test_nearest_neighbor_device_card_matches_cpu(cuda):
    """1-NN indices on the card equal the CPU's (targets drawn away from
    ties: each is a source point plus a small offset)."""
    from dropclip_tpu_torch.geom.knn import nearest_neighbor_device

    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    pick = rng.integers(0, len(src), 5000)
    tgt = src[pick] + rng.normal(0, 1e-4, (5000, 3)).astype(np.float32)
    ref = nearest_neighbor_device(torch.from_numpy(src), tgt)
    got = nearest_neighbor_device(torch.from_numpy(src).to(cuda), tgt)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(ref.long(), torch.from_numpy(pick))


# ---- the tooling slice: K1 as a registered op, in a CUDA graph, and its
# weight gradient with a static row bound

def _k1_case(cuda, level=1, c=64, cout=96, seed=7):
    lv = _folded_level((4, 4, 2), level=level)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tuple(lv.occ.shape) + (c,), generator=gen,
                    device=cuda) * lv.occ[..., None]
    w = torch.randn((27, c, cout), generator=gen, device=cuda) * 0.05
    return lv, x, w


def test_k1_registered_op_equals_the_direct_call(cuda):
    """``torch.ops.dropclip.brick_conv3`` with the level's schedule gives
    exactly the wrapper's result (the same launch), counts one launch,
    and its fake implementation gives the output's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    lv, x, w = _k1_case(cuda)
    sched = row_order(lv.occ, lv.nbr)
    want = brick_conv3(x, lv.nbr, w, lv.occ, sched)
    before = k1_count.launches
    got = torch.ops.dropclip.brick_conv3(x, lv.nbr, w, lv.occ, *sched)
    assert k1_count.launches - before == 1
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = torch.ops.dropclip.brick_conv3(
            *(mode.from_tensor(t) for t in (x, lv.nbr, w, lv.occ)),
            None, None, None)
    assert fake.shape == want.shape and fake.dtype == want.dtype


def test_k1_and_its_dgrad_in_a_cuda_graph_equal_eager(cuda):
    """K1's forward and its dgrad (``BrickConv3Fn``'s backward, K1 with
    mirrored taps) captured in one CUDA graph and replayed on new inputs
    copied into the captured buffers: the same results as eager calls
    (exactly: the same launches on the same data), and the capture counts
    its two launches while a replay counts none."""
    from dropclip_tpu_torch.kernels.brick_conv3 import (BrickConv3Fn,
                                                        Schedule)

    lv, x, w = _k1_case(cuda)
    gen = torch.Generator(device="cuda").manual_seed(8)
    dy = torch.randn(tuple(lv.occ.shape) + (w.shape[2],), generator=gen,
                     device=cuda)
    sched = Schedule(*row_order(lv.occ, lv.nbr))

    def step(xs):
        xs = xs.detach().requires_grad_(True)
        out = BrickConv3Fn.apply(xs, w, lv.nbr, lv.occ, sched)
        (out * dy).sum().backward()
        return out.detach(), xs.grad

    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = k1_count.launches
    with torch.cuda.graph(graph):
        g_out, g_dx = step(static_x)
    assert k1_count.launches - before == 2
    for seed in (9, 10):
        new = torch.randn(x.shape, generator=gen.manual_seed(seed),
                          device=cuda) * lv.occ[..., None]
        static_x.copy_(new)
        before = k1_count.launches
        graph.replay()
        torch.cuda.synchronize()
        assert k1_count.launches == before
        out, dx = step(new)
        assert torch.equal(g_out, out) and torch.equal(g_dx, dx)


@pytest.mark.parametrize("level,c,cout", [(0, 32, 32), (2, 128, 256)])
def test_k1_wgrad_static_bound_equals_count_read(cuda, level, c, cout):
    """The weight gradient over the schedule's first ``n_rows`` rows, a
    bound at or above the occupied count (the count itself, plus 1000,
    every row), against the count-read weight gradient: 1e-5 of
    max|ref| (the rows past the count add exact zeros; only the
    product's order of summation moves)."""
    from dropclip_tpu_torch.kernels.brick_conv3 import brick_conv3_wgrad

    lv, x, _ = _k1_case(cuda, level=level, c=c, cout=cout)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dy = torch.randn(tuple(lv.occ.shape) + (cout,), generator=gen,
                     device=cuda) * lv.occ[..., None]
    sched = row_order(lv.occ, lv.nbr)
    ref = brick_conv3_wgrad(x, dy, lv.nbr, lv.occ, sched)
    n_occ, rows = int(sched[1]), sched[0].numel()
    assert float(ref.abs().max()) > 0
    for n in (n_occ, min(n_occ + 1000, rows), rows):
        got = brick_conv3_wgrad(x, dy, lv.nbr, lv.occ, sched, n_rows=n)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


# the parameters' update gap of the scanned trainer against the eager
# loop from one warm state: on an H100 the sound runs read 2.3e-6 to
# 3.0e-6 and a frozen step count 0.27 to 0.28 (PERF.md)
SCAN_GAP = 1e-3


def _scanned_against_eager(cuda, remat, dropout):
    """A small student (MinkUNet14A, 32-d) on six staged scenes, three
    eager steps to a warm state, then six steps from copies of it: the
    eager step loop, and ``make_scanned_train`` in two chunks of three
    (one step captured as a CUDA graph, replayed), dropout drawn from
    generators seeded alike. Returns (graph losses, eager losses, the
    parameters' update gap ||graph - eager|| / ||eager - warm|| over
    every parameter, the chunk function)."""
    import copy

    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.distill import engine
    from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                        make_optimizer)

    rng = np.random.RandomState(0)
    s, m, f = 6, 512, 32
    coords, mask = make_tabletop_coords(rng, s, m, n_occ=400, ext=12)
    caps = bricks.autotune_brick_capacities(coords, mask, slack=1.5,
                                            brick_shape=(4, 4, 2))
    cfg = CfgNode(dict(arch_3d="MinkUNet14A", feat_dim=f, use_color=True,
                       sparse_backend="bricks", brick_shape=[4, 4, 2],
                       brick_capacities=list(caps), remat=remat,
                       dropout_rate=dropout, base_lr=3e-4, min_lr=1e-4,
                       epochs=4,
                       weight_decay=1e-5, max_norm=5.0, loss_type="cosine"))
    put = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    data = engine.DistilBatch(
        put(coords), put(mask),
        put((rng.randn(s, m, 6) * mask[..., None]).astype(np.float32)),
        put((rng.randn(s, m, f) * mask[..., None]).astype(np.float32)),
        put(np.zeros((s, m), np.int32)), put(np.zeros((s, m), np.int32)))
    rows = np.array([[0, 1], [2, 3], [4, 5], [1, 4], [3, 0], [5, 2]])
    net = engine.build_student_for(
        cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
    step = engine.make_train_step(cfg)

    def batch(r):
        return engine.DistilBatch(*(t[put(r)] for t in data))

    warm = create_train_state(net, make_optimizer(cfg, 3))
    gen = torch.Generator(device=cuda).manual_seed(4)
    for r in ([1, 2], [3, 4], [5, 0]):
        step(warm, batch(r), gen)
    init = {k: v.clone() for k, v in warm.model.named_parameters()}
    eager = copy.deepcopy(warm)
    gen = torch.Generator(device=cuda).manual_seed(5)
    want = [float(step(eager, batch(r), gen)[1]["distil_loss"])
            for r in rows]
    scanned = copy.deepcopy(warm)
    chunk = engine.make_scanned_train(cfg)
    gen = torch.Generator(device=cuda).manual_seed(5)
    got = []
    for part in (rows[:3], rows[3:]):
        _, _, metrics = chunk(scanned, data, part, gen)
        got += metrics["distil_loss"].tolist()
    a = dict(scanned.model.named_parameters())
    b = dict(eager.model.named_parameters())
    d = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in a)
    u = sum(float(((b[k] - init[k]).double() ** 2).sum()) for k in a)
    assert u > 0
    return got, want, (d / u) ** 0.5, chunk


@pytest.mark.parametrize("remat,dropout", [(False, 0.0), (True, 0.0),
                                           (False, 0.2)])
def test_scanned_train_graph_matches_eager_steps(cuda, remat, dropout,
                                                 monkeypatch):
    """``make_scanned_train`` on the card against the eager step loop
    from one warm state on the same staged data and schedule, with and
    without remat, and with dropout (the graph registers the generator,
    so each replay draws the next step's masks): losses 1e-4 relative,
    the parameters' update gap within SCAN_GAP (the graph's weight
    gradients sum over a static row bound in another order). Without
    remat and dropout, the planted fault, a graph whose step count does
    not advance, must read past SCAN_GAP."""
    from dropclip_tpu_torch.distill.train_state import AmsgradChain

    got, want, gap, chunk = _scanned_against_eager(cuda, remat, dropout)
    assert chunk.cache["step"].graph is not None
    # forward and dgrad of 16 convs, and with remat the forward again
    assert chunk.cache["step"].k1_launches == (3 if remat else 2) * 16
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert gap <= SCAN_GAP
    if remat or dropout:
        return
    update = AmsgradChain.update

    def frozen(chain, model, opt_state, count=None):
        norm = update(chain, model, opt_state, count)
        if count is not None:
            count.sub_(1)
        return norm

    monkeypatch.setattr(AmsgradChain, "update", frozen)
    assert _scanned_against_eager(cuda, remat, dropout)[2] > SCAN_GAP


def test_sparse_quantize_on_card_equals_cpu(cuda):
    """``geom.voxelize.sparse_quantize`` on CUDA tensors (batched, with
    labels and a valid mask, past capacity in one scene) returns CUDA
    tensors equal, field for field, to the CPU run: integer work only."""
    from dropclip_tpu_torch.geom.voxelize import sparse_quantize

    rng = np.random.RandomState(0)
    xyz = torch.as_tensor(rng.rand(3, 4000, 3).astype(np.float32))
    xyz[1] *= 4.0  # more voxels than the capacity
    valid = torch.as_tensor(rng.rand(3, 4000) < 0.9)
    labels = torch.as_tensor(rng.randint(0, 4, (3, 4000)).astype(np.int32))
    ref = sparse_quantize(xyz, 0.1, 2048, valid=valid, labels=labels)
    got = sparse_quantize(xyz.to(cuda), 0.1, 2048, valid=valid.to(cuda),
                          labels=labels.to(cuda))
    assert bool(ref.overflowed[1]) and not bool(ref.overflowed[0])
    for name, r in ref._asdict().items():
        g = getattr(got, name)
        assert g.is_cuda and g.dtype == r.dtype, name
        assert torch.equal(g.cpu(), r), name
