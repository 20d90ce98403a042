"""Pillar-layout ops: dropclip_tpu_torch against the JAX package on the
same numpy inputs, float32 on the CPU.

- K2's plain version (``kernels/pillar_conv3.pillar_conv3_plain``, which
  the wrapper takes for CPU tensors) against ``pallas_pillar_conv3`` in
  interpret mode and ``pillar_conv3_xla``, run as tests/test_pallas_pillar.py
  runs them (dense 4x4 pillar grids, C = Cout = 128): relu on and off, Z 8
  and 16, and a scene whose neighbours are all misses;
- ``pillar_conv_xla`` (the k5 stem), ``pillar_down_conv`` and
  ``pillar_up_conv`` against their JAX counterparts;
- the wrapper's gate: every shape the kernel takes (Z = 24 and 40, which
  trip the JAX module's Pallas branch), and a raise for what it does not.

Tolerance: 1e-5 of max|ref| (float32 summation order over <= 27*128
terms).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dropclip_tpu.sparse import pillar_ops as jops
from dropclip_tpu.sparse.pallas_pillar import (PILLAR_DIRS as J_DIRS,
                                               dense_pillar_scene,
                                               pallas_pillar_conv3,
                                               pillar_conv3_xla,
                                               pillar_tile)
from dropclip_tpu_torch.kernels.pillar_conv3 import (PILLAR_DIRS,
                                                     pillar_conv3,
                                                     pillar_conv3_plain)
from dropclip_tpu_torch.sparse import pillar_ops as tops

TOL = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    den = max(float(np.abs(ref).max()), 1e-6)
    assert np.abs(got - ref).max() <= TOL * den, np.abs(got - ref).max()


def _problem(rng, gx, gy, z, c, cout, occupancy=0.5):
    feats, nbr, occ = dense_pillar_scene(rng, gx, gy, z, c, occupancy)
    w9 = (rng.randn(9, 3, c, cout) * 0.05).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return feats, nbr, w9, occ, scale, bias


def _port(feats, nbr, w9, occ, scale, bias, relu):
    return pillar_conv3(torch.as_tensor(feats), torch.as_tensor(nbr),
                        torch.as_tensor(w9), torch.as_tensor(occ),
                        torch.as_tensor(scale), torch.as_tensor(bias),
                        relu=relu).numpy()


def test_pillar_dirs_match():
    assert PILLAR_DIRS == J_DIRS


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("z", [8, 16])
def test_k2_plain_matches_pallas_and_xla(rng, relu, z):
    args = _problem(rng, 4, 4, z, 128, 128)
    jargs = [jnp.asarray(a) for a in args]
    got = _port(*args, relu=relu)
    _close(got, pillar_conv3_xla(*jargs, relu=relu))
    _close(got, pallas_pillar_conv3(*jargs, relu=relu,
                                    interpret=jax.default_backend() != "tpu"))


def test_k2_plain_empty_neighbors(rng):
    """Pillars whose neighbours are all misses reduce to a column conv;
    the port's misses are any row outside [0, P), here P and -1."""
    z, c, cout = 8, 128, 128
    p = pillar_tile(z)
    feats = rng.randn(p, z, c).astype(np.float32)
    occ = np.ones((p, z), bool)
    nbr = np.full((p, 9), p, np.int32)
    nbr[:, 4] = np.arange(p)
    w9 = (rng.randn(9, 3, c, cout) * 0.05).astype(np.float32)
    ones, zeros = np.ones(cout, np.float32), np.zeros(cout, np.float32)
    ref = pallas_pillar_conv3(*[jnp.asarray(a) for a in
                                (feats, nbr, w9, occ, ones, zeros)],
                              relu=True,
                              interpret=jax.default_backend() != "tpu")
    _close(_port(feats, nbr, w9, occ, ones, zeros, relu=True), ref)
    nbr[:, :4] = -1
    _close(_port(feats, nbr, w9, occ, ones, zeros, relu=True), ref)


def _sparse_scene(rng, gx=5, gy=4, z=16, c=6):
    """A dense pillar grid with a third of the sites removed (misses)."""
    feats, nbr, occ = dense_pillar_scene(rng, gx, gy, z, c, 0.4)
    p = gx * gy
    gone = rng.rand(p) < 0.3
    nbr = np.where(gone[np.minimum(nbr, p - 1)] | (nbr == p), p, nbr)
    feats[gone] = 0
    return feats, nbr.astype(np.int32), occ


def test_stem_k5_matches_jax(rng):
    feats, _, _ = _sparse_scene(rng)
    p = feats.shape[0]
    nbr25 = rng.randint(0, p + 1, size=(p, 25)).astype(np.int32)
    w = (rng.randn(25, 5, 6, 10) * 0.1).astype(np.float32)
    ref = jops.pillar_conv_xla(jnp.asarray(feats), jnp.asarray(nbr25),
                               jnp.asarray(w))
    got = tops.pillar_conv_xla(torch.as_tensor(feats),
                               torch.as_tensor(nbr25), torch.as_tensor(w))
    _close(got.numpy(), ref)


def test_down_and_up_conv_match_jax(rng):
    feats, _, _ = _sparse_scene(rng, z=16, c=7)
    p = feats.shape[0]
    pc = 6
    child = rng.randint(0, p + 1, size=(pc, 4)).astype(np.int32)
    w = (rng.randn(4, 2, 7, 9) * 0.2).astype(np.float32)
    ref = jops.pillar_down_conv(jnp.asarray(feats), jnp.asarray(child),
                                jnp.asarray(w))
    got = tops.pillar_down_conv(torch.as_tensor(feats),
                                torch.as_tensor(child), torch.as_tensor(w))
    _close(got.numpy(), ref)

    coarse = np.array(ref)  # (pc, 8, 9)
    parent = rng.randint(0, pc + 1, size=(p,)).astype(np.int32)
    parity = rng.randint(0, 4, size=(p,)).astype(np.int32)
    wu = (rng.randn(4, 2, 9, 5) * 0.2).astype(np.float32)
    ref = jops.pillar_up_conv(jnp.asarray(coarse), jnp.asarray(parent),
                              jnp.asarray(parity), jnp.asarray(wu))
    got = tops.pillar_up_conv(torch.as_tensor(coarse),
                              torch.as_tensor(parent),
                              torch.as_tensor(parity), torch.as_tensor(wu))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("z,c,cout", [(24, 128, 128), (40, 16, 8),
                                      (5, 3, 200)])
def test_k2_gate_takes_any_z_c_cout(rng, z, c, cout):
    """The JAX Pallas gate let Z = 24 or 40 through to an assert on the
    pillar tile; the port's wrapper takes every Z, C and Cout and equals
    the XLA formulation."""
    args = _problem(rng, 3, 2, z, c, cout)
    _close(_port(*args, relu=True),
           pillar_conv3_xla(*[jnp.asarray(a) for a in args], relu=True))


def test_k2_gate_raises_on_what_the_kernel_does_not_take():
    p, z, c, co = 4, 8, 16, 8
    x = torch.zeros((p, z, c))
    nbr = torch.zeros((p, 9), dtype=torch.int32)
    w = torch.zeros((9, 3, c, co))
    occ = torch.ones((p, z), dtype=torch.bool)
    s, b = torch.ones(co), torch.zeros(co)
    pillar_conv3(x, nbr, w, occ, s, b)
    bad = [
        (TypeError, (x.half(), nbr, w.half(), occ, s, b)),
        (TypeError, (x, nbr.long(), w, occ, s, b)),
        (TypeError, (x, nbr, w.bfloat16(), occ, s, b)),
        (TypeError, (x, nbr, w, occ, s.double(), b)),
        (ValueError, (x, nbr[:3], w, occ, s, b)),
        (ValueError, (x, nbr, w.reshape(27, c, co), occ, s, b)),
        (ValueError, (x, nbr, w, occ[:, :4], s, b)),
        (ValueError, (x, nbr, w, occ, s[:4], b)),
        (ValueError, (x.transpose(0, 1), nbr, w, occ, s, b)),
        (ValueError, (x[:, ::2], nbr, w, occ[:, ::2], s, b)),
    ]
    for err, args in bad:
        with pytest.raises(err):
            pillar_conv3(*args)


def test_k2_plain_is_the_wrapper_on_cpu(rng):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    args = _problem(rng, 2, 2, 8, 4, 4)
    before = pillar_conv3.launches
    got = _port(*args, relu=False)
    ref = pillar_conv3_plain(*[torch.as_tensor(a) for a in args],
                             relu=False).numpy()
    assert pillar_conv3.launches == before
    assert np.array_equal(got, ref)
