"""DINO v1 hi-res descriptors: dropclip_tpu_torch.teachers.dino_v1 against
the JAX ViTExtractor with the same weights (the JAX init carried across by
dropclip_tpu_torch.convert.dino_v1_state_dict). The JAX package runs with
``use_flash`` off, as its own tests do on the CPU; the port's non-captured
layers take the plain versions of K3/K4/K5 there."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.teachers import dino_v1 as jdino
from dropclip_tpu_torch.convert import dino_v1_state_dict
from dropclip_tpu_torch.teachers import dino_v1
from torch_cv2_stub import use_cv2


def jax_params(ex, seed):
    """The JAX extractor's init tree with LayerNorms and the cls token
    moved off their init values."""
    params = jax.tree_util.tree_map(np.asarray, ex.variables["params"])
    rs = np.random.RandomState(seed)
    for name in [k for k in params if k.startswith("block_")] + ["norm"]:
        ln = params[name]["norm1"] if name != "norm" else params[name]
        ln["scale"] = ln["scale"] + 0.1 * rs.randn(*ln["scale"].shape
                                                   ).astype(np.float32)
        ln["bias"] = 0.1 * rs.randn(*ln["bias"].shape).astype(np.float32)
    params["cls_token"] = 0.1 * rs.randn(*params["cls_token"].shape
                                         ).astype(np.float32)
    ex.variables = {"params": params}
    return params


@pytest.fixture(scope="module", params=["tiny-test", "tiny-test-deep"])
def pair(request):
    jex = jdino.ViTExtractor(request.param, stride=2)
    params = jax_params(jex, seed=1)
    pex = dino_v1.ViTExtractor(request.param, stride=2,
                               state_dict=dino_v1_state_dict(params),
                               device="cpu")
    return jex, pex


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _batch(seed, hw=(16, 20)):
    return np.random.RandomState(seed).randn(2, *hw, 3).astype(np.float32)


@pytest.mark.parametrize("bin_,include_cls", [(False, False), (True, False),
                                              (False, True)])
@pytest.mark.parametrize("facet", ["key", "query", "value", "token"])
def test_descriptors_match_jax(pair, facet, bin_, include_cls):
    """Every descriptor facet of the last layer, raw, log-binned and with
    the cls token, at stride 2 on a non-square 16x20 input (a 7x9 grid,
    the +0.1 pos-embed resize): within 1e-5 of max|ref|."""
    jex, pex = pair
    px = _batch(0)
    layer = jex.model.layers - 1
    ref = jex.extract_descriptors(px, layer=layer, facet=facet, bin=bin_,
                                  include_cls=include_cls)
    got = pex.extract_descriptors(px, layer=layer, facet=facet, bin=bin_,
                                  include_cls=include_cls)
    _close(got, ref)
    assert pex.num_patches == jex.num_patches == (7, 9)
    assert pex.load_size == jex.load_size


def test_saliency_matches_jax(pair):
    """cls-attention saliency of the last layer (materialised float32
    probabilities, heads 0, 2, 4, 5): within 1e-5."""
    jex, pex = pair
    px = _batch(1)
    _close(pex.extract_saliency_maps(px), jex.extract_saliency_maps(px))


def test_every_facet_of_every_layer_matches_jax(pair):
    """One forward capturing all five facets of every layer: the captured
    layers materialise their probabilities, the final tokens too."""
    jex, pex = pair
    px = _batch(2)
    capture = tuple((i, f) for i in range(jex.model.layers)
                    for f in dino_v1.FACETS)
    rx, rc = jex._fwd(jex.variables, jnp.asarray(px), capture)
    with torch.no_grad():
        gx, gc = pex.model(torch.as_tensor(px), capture=capture)
    _close(gx, rx)
    assert set(gc) == set(rc)
    for key in rc:
        _close(gc[key], rc[key])


def test_kernel_route_layers_match_the_materialised_ones(pair):
    """A layer left out of ``capture`` goes through ``attend`` (here the
    plain versions of the kernels): the final tokens agree with the run
    that materialises every layer's probabilities."""
    _, pex = pair
    px = torch.as_tensor(_batch(3))
    every = tuple((i, "attn") for i in range(pex.model.layers))
    with torch.no_grad():
        a, _ = pex.model(px)
        b, _ = pex.model(px, capture=every)
    _close(a.numpy(), b.numpy())


def test_log_bin_matches_jax():
    rs = np.random.RandomState(4)
    for grid, hier in (((5, 7), 2), ((9, 4), 3), ((1, 1), 2)):
        x = rs.randn(2, 3, grid[0] * grid[1], 5).astype(np.float32)
        ref = jdino.log_bin(jnp.asarray(x), grid, hier)
        _close(dino_v1.log_bin(torch.as_tensor(x), grid, hier), ref)


def test_checks_raise_as_in_jax(pair):
    """The stride must divide the patch; descriptors refuse the attn
    facet, bin with include_cls and a layer out of range; saliency takes
    only dino_vits8 and the tiny configs."""
    jex, pex = pair
    px = _batch(5)
    for bad in (dict(facet="attn"), dict(bin=True, include_cls=True),
                dict(layer=jex.model.layers)):
        for ex in (jex, pex):
            with pytest.raises(ValueError):
                ex.extract_descriptors(px, **bad)
    with pytest.raises(ValueError, match="stride 3 should divide"):
        dino_v1.ViTExtractor("tiny-test", stride=3, device="cpu"
                             ).extract_descriptors(px, layer=1)
    with pytest.raises(ValueError):
        jdino.ViTExtractor("tiny-test", stride=3)
    with pytest.raises(ValueError, match="unknown DINO v1"):
        dino_v1.build_dino_v1("dino_vitl8", 4, device="cpu")
    ex = dino_v1.ViTExtractor("dino_vits16", stride=16, device="cpu")
    with pytest.raises(ValueError, match="saliency"):
        ex.extract_saliency_maps(np.zeros((1, 32, 32, 3), np.float32))


def test_preprocess_matches_jax(pair, monkeypatch):
    """uint8 -> normalised float32, resized to a short side of 16 and to
    an explicit (h, w): with cv2's LANCZOS4, or where cv2 is not installed
    with its stand-in in both packages (the sizes and the normalisation
    are the port's own either way)."""
    use_cv2(monkeypatch)
    jex, pex = pair
    img = (np.random.RandomState(6).rand(32, 40, 3) * 255).astype(np.uint8)
    for size in (None, 16, (12, 20)):
        ref = jex.preprocess(img, load_size=size)
        got = pex.preprocess(img, load_size=size)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_timm_names_take_the_timm_normalisation():
    ex = dino_v1.ViTExtractor("vit_small_patch16_224", stride=16,
                              device="cpu")
    assert ex.mean == ex.std == dino_v1.TIMM_MEAN
    assert dino_v1.ViTExtractor("tiny-test", stride=4,
                                device="cpu").mean == dino_v1.DINO_V1_MEAN


@pytest.mark.slow
def test_vits8_stride4_full_width_matches_jax():
    """dino_vits8 at full width and stride 4 on one 64x64 input (T = 226,
    6 heads: K4's route on the card): key descriptors of layer 11 and the
    saliency within 1e-5 of max|ref|."""
    jex = jdino.ViTExtractor("dino_vits8", stride=4)
    params = jax_params(jex, seed=7)
    pex = dino_v1.ViTExtractor("dino_vits8", stride=4, device="cpu",
                               state_dict=dino_v1_state_dict(params))
    px = np.random.RandomState(8).randn(1, 64, 64, 3).astype(np.float32)
    _close(pex.extract_descriptors(px), jex.extract_descriptors(px))
    _close(pex.extract_saliency_maps(px), jex.extract_saliency_maps(px))
