"""dropclip_tpu_torch.distill.loss and core.metrics against the JAX
package on the same numpy inputs: every loss and its gradient, with
padded rows, all-zero rows and absent labels in the data."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core import metrics as jmetrics
from dropclip_tpu.distill import loss as jloss
from dropclip_tpu_torch.core import metrics
from dropclip_tpu_torch.distill import loss

B, M, C, L = 2, 60, 8, 6


def _data(seed=0):
    rng = np.random.RandomState(seed)
    out = rng.randn(B, M, C).astype(np.float32)
    out[0, 3] = 0.0  # an all-zero row of a real voxel
    tgt = rng.randn(B, M, C).astype(np.float32)
    mask = rng.rand(B, M) < 0.8
    labels = rng.randint(0, L - 1, (B, M)).astype(np.int32)  # label L-1 absent
    return out, tgt, mask, labels


def _both(jfn, tfn, args, grad_argnums):
    """(value, grads) of a scalar loss in both packages."""
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=grad_argnums))(*args)
    targs = [torch.tensor(np.asarray(a)) for a in args]
    for i in grad_argnums:
        targs[i].requires_grad_(True)
    tv = tfn(*targs)
    tv.backward()
    return (float(tv.detach()), [targs[i].grad.numpy() for i in grad_argnums],
            float(jv), [np.asarray(g) for g in jg])


def _close(res, tol=1e-6):
    tv, tg, jv, jg = res
    assert tv == pytest.approx(jv, rel=tol, abs=tol)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["cosine_distil_loss", "l1_distil_loss",
                                  "average_cosine_distance"])
def test_distil_losses_and_grads_match_jax(name):
    """value and d/d(out): 1e-6; padded rows get no gradient."""
    out, tgt, mask, _ = _data()
    res = _both(lambda o, t, m: getattr(jloss, name)(o, t, m),
                lambda o, t, m: getattr(loss, name)(o, t, m),
                (out, tgt, mask), (0,))
    _close(res)
    assert np.abs(res[1][0][~mask]).max() == 0.0


@pytest.mark.parametrize("part", [0, 1])
def test_aux_hinge_and_grads_match_jax(part):
    """pos (0) and margin (1) terms of the batched hinge and their
    gradients: 1e-6."""
    out, _, mask, labels = _data(1)
    _close(_both(lambda o, l, m: jloss.aux_hinge_loss(o, l, m, L)[part],
                 lambda o, l, m: loss.aux_hinge_loss(o, l, m, L)[part],
                 (out, labels, mask), (0,)))


def test_cross_entropy_and_grads_match_jax():
    """Per-voxel CE with the ignore label: 1e-6."""
    rng = np.random.RandomState(2)
    logits = rng.randn(B, M, 5).astype(np.float32)
    _, _, mask, labels = _data(2)
    labels = np.where(rng.rand(B, M) < 0.2, 255, labels % 5).astype(np.int32)
    _close(_both(lambda g, l, m: jloss.cross_entropy_cls_loss(g, l, m),
                 lambda g, l, m: loss.cross_entropy_cls_loss(g, l, m),
                 (logits, labels, mask), (0,)))


def test_supcon_and_grads_match_jax():
    """SupCon over labeled points: the value with padded rows, and the
    gradient without them, 1e-6. With padded rows the JAX gradient is NaN
    (a padded anchor's row max is -inf, and exp(inf) * 0 meets the
    backward), a fault of the reference the port does not copy: its
    gradient there is finite and zero on the padded rows."""
    rng = np.random.RandomState(3)
    f = rng.randn(40, C).astype(np.float32)
    lab = rng.randint(0, 4, 40).astype(np.int32)
    m = rng.rand(40) < 0.85
    tv, tg, jv, jg = _both(jloss.supervised_contrastive_loss,
                           loss.supervised_contrastive_loss, (f, lab, m),
                           (0,))
    assert tv == pytest.approx(jv, rel=1e-6)
    assert np.isnan(jg[0]).any()
    assert np.isfinite(tg[0]).all() and np.abs(tg[0][~m]).max() == 0.0
    _close(_both(jloss.supervised_contrastive_loss,
                 loss.supervised_contrastive_loss,
                 (f, lab, np.ones(40, bool)), (0,)))


@pytest.mark.parametrize("masked", [False, True])
def test_triplet_kl_and_grads_match_jax(masked):
    """Triplet-KL, plain mean or masked: 1e-6 for the loss and the three
    gradients."""
    rng = np.random.RandomState(4)
    a, p, n = (rng.randn(30, 7).astype(np.float32) for _ in range(3))
    m = rng.rand(30) < 0.7
    if masked:
        res = _both(lambda x, y, z, w: jloss.triplet_kl_loss(x, y, z, 0.5, w),
                    lambda x, y, z, w: loss.triplet_kl_loss(x, y, z, 0.5, w),
                    (a, p, n, m), (0, 1, 2))
    else:
        res = _both(jloss.triplet_kl_loss, loss.triplet_kl_loss, (a, p, n),
                    (0, 1, 2))
    _close(res)


def test_metrics_match_jax():
    """grounding_metrics, intersection_and_union and masked_mean: equal
    counts, 1e-6 for the rates."""
    rng = np.random.RandomState(5)
    pred = rng.rand(7, 90).astype(np.float32)
    tgt = rng.rand(7, 90) < 0.4
    qm = np.arange(7) < 5
    pm = rng.rand(90) < 0.9
    jm = jmetrics.grounding_metrics(pred, tgt, jnp.asarray(qm),
                                    jnp.asarray(pm))
    tm = metrics.grounding_metrics(torch.as_tensor(pred),
                                   torch.as_tensor(tgt), torch.as_tensor(qm),
                                   torch.as_tensor(pm))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    out = rng.randint(0, 4, 200)
    lab = np.where(rng.rand(200) < 0.1, 255, rng.randint(0, 4, 200))
    valid = rng.rand(200) < 0.9
    for a, b in zip(
            metrics.intersection_and_union(torch.as_tensor(out),
                                           torch.as_tensor(lab), 4,
                                           valid_mask=torch.as_tensor(valid)),
            jmetrics.intersection_and_union(jnp.asarray(out),
                                            jnp.asarray(lab), 4,
                                            valid_mask=jnp.asarray(valid))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = rng.randn(6, 9).astype(np.float32)
    mk = rng.rand(6, 9) < 0.5
    for axis in (None, 1):
        np.testing.assert_allclose(
            metrics.masked_mean(torch.as_tensor(x), torch.as_tensor(mk),
                                axis).numpy(),
            np.asarray(jmetrics.masked_mean(jnp.asarray(x), jnp.asarray(mk),
                                            axis)), rtol=1e-6)
