"""K2: the k3 submanifold pillar conv as a hand-written CUDA kernel.

Replaces ``dropclip_tpu/sparse/pallas_pillar.py::pallas_pillar_conv3``.
The source is ``csrc/pillar_conv3.cu`` (design and bound in its header
note); it is compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/``
at first use and loaded with ``ctypes`` (``kernels/nvcc.py``).

``pillar_conv3`` is the wrapper: it checks every shape, type, device and
contiguity the kernel needs (and raises on anything else, on every
device), then launches the kernel for CUDA tensors, or takes the plain
version, ``pillar_conv3_plain`` (a port of ``pallas_pillar.
pillar_conv3_xla``), for CPU tensors. ``pillar_conv3.launches`` counts
kernel launches. The TPU kernel's limits (Z a multiple of 8, C and Cout
multiples of 128, P a multiple of the pillar tile, output chunks of 8192
pillars) were Mosaic's and do not apply.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..sparse.pillar_ops import gather_rows, z_shift
from .nvcc import library

# xy-direction order: dx-major, dy-minor, both ascending; index 4 is the
# pillar itself (nbr[:, 4] == row in a well-formed table).
PILLAR_DIRS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dropclip_pillar_conv3.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                          i, i, i, i, p]
    lib.dropclip_pillar_conv3.restype = i


LIB = library("pillar_conv3", _bind)


def pillar_conv3_plain(feats: torch.Tensor, nbr: torch.Tensor,
                       weights: torch.Tensor, occ: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2 (``pillar_conv3_xla``): gather the 9
    neighbour columns, three z-shifted products in float32, then
    ``occ * relu?(y * scale + bias)``, cast to the feats dtype."""
    cols = gather_rows(feats, nbr).float()  # (P, 9, Z, C)
    w = weights.float()
    y = sum(torch.einsum("pjzc,jco->pzo", z_shift(cols, dzi - 1), w[:, dzi])
            for dzi in range(3))
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return (y * occ[..., None]).to(feats.dtype)


def _check(feats, nbr, weights, occ, scale, bias
           ) -> Tuple[int, int, int, int]:
    """Every condition the kernel needs; raises on anything else."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (P, Z, C), got {tuple(feats.shape)}")
    p, z, c = feats.shape
    if feats.dtype not in _DTYPES:
        raise TypeError(f"feats dtype {feats.dtype} not float32/bfloat16")
    if weights.dtype != feats.dtype:
        raise TypeError(f"weights dtype {weights.dtype} != feats dtype "
                        f"{feats.dtype}")
    if nbr.dtype != torch.int32 or occ.dtype != torch.bool:
        raise TypeError(f"nbr must be int32 and occ bool, got {nbr.dtype}, "
                        f"{occ.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    if weights.dim() != 4 or tuple(weights.shape[:3]) != (9, 3, c):
        raise ValueError(f"weights must be (9, 3, {c}, Cout), got "
                         f"{tuple(weights.shape)}")
    cout = weights.shape[3]
    if tuple(nbr.shape) != (p, 9):
        raise ValueError(f"nbr must be ({p}, 9), got {tuple(nbr.shape)}")
    if tuple(occ.shape) != (p, z):
        raise ValueError(f"occ must be ({p}, {z}), got {tuple(occ.shape)}")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale and bias must be ({cout},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    for name, t in (("feats", feats), ("nbr", nbr), ("weights", weights),
                    ("occ", occ), ("scale", scale), ("bias", bias)):
        if t.device != feats.device:
            raise ValueError(f"{name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p * z >= 2 ** 31:
        raise ValueError("pillar_conv3 indexes (pillar, z) slots in int32")
    return p, z, c, cout


def pillar_conv3(feats: torch.Tensor, nbr: torch.Tensor,
                 weights: torch.Tensor, occ: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor,
                 relu: bool = True) -> torch.Tensor:
    """Fused k3 submanifold pillar conv + folded-BN epilogue:
    ``occ * relu?(conv3(feats) * scale + bias)`` in the feats dtype.

    feats (P, Z, C) float32 or bfloat16; nbr (P, 9) int32 xy-neighbours in
    ``PILLAR_DIRS`` order (miss: any row outside [0, P)); weights
    (9, 3, C, Cout) in the feats dtype, dz ascending; occ (P, Z) bool;
    scale and bias (Cout,) float32. CUDA tensors run K2, CPU tensors the
    plain version.
    """
    p, z, c, cout = _check(feats, nbr, weights, occ, scale, bias)
    if not feats.is_cuda:
        return pillar_conv3_plain(feats, nbr, weights, occ, scale, bias,
                                  relu)
    out = torch.empty((p, z, cout), dtype=feats.dtype, device=feats.device)
    if p * z == 0 or cout == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(feats.device):
        # occupied slots first (ascending), then the empty ones, and their
        # count, all on the device: the kernel computes only the occupied
        # slots and writes zeros to the rest; float32 scratch for the sums
        # of its tap groups
        occ_flat = occ.reshape(-1)
        n_occ = occ_flat.sum(dtype=torch.int32)
        order = torch.argsort(torch.logical_not(occ_flat).to(torch.uint8),
                              stable=True).to(torch.int32)
        sums = torch.zeros((p * z, cout), dtype=torch.float32,
                           device=feats.device)
        n_blocks = 2 * torch.cuda.get_device_properties(
            feats.device).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dropclip_pillar_conv3(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), order.data_ptr(),
            n_occ.data_ptr(), sums.data_ptr(), out.data_ptr(), p, z, c,
            cout, int(relu), _DTYPES[feats.dtype], n_blocks, stream)
    LIB.check(err, "pillar_conv3")
    pillar_conv3.launches += 1
    return out


pillar_conv3.launches = 0
