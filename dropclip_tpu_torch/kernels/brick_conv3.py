"""K1: the k3 submanifold brick conv as a hand-written CUDA kernel.

Replaces ``dropclip_tpu/sparse/pallas_conv.py::pallas_brick_conv3``. The
source is ``csrc/brick_conv3.cu`` (design and bound in its header note);
it is compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at
first use and loaded with ``ctypes`` (``kernels/nvcc.py``).

``brick_conv3`` is the wrapper: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it takes the plain version,
``brick_conv3_plain`` (``sparse.bricks.brick_conv`` with ksize 3).
``brick_conv3.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..sparse.bricks import BrickLevel, brick_conv
from .nvcc import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dropclip_brick_conv3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         i, p]
    lib.dropclip_brick_conv3.restype = i


LIB = library("brick_conv3", _bind)


def brick_conv3_plain(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, occ: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of K1 (halo gather + 27-tap matmul)."""
    level = BrickLevel(coords=None, keys=None, mask=None, occ=occ, nbr=nbr)
    return brick_conv(feats, level, weights, ksize=3)


def _check(feats, nbr, weights, occ) -> Tuple[int, int, int, int, int, int]:
    if feats.dim() != 5:
        raise ValueError(f"feats must be (Bm, bx, by, bz, C), got "
                         f"{tuple(feats.shape)}")
    bm, bx, by, bz, c = feats.shape
    for s in (bx, by, bz):
        if s < 2 or s & (s - 1):
            raise ValueError(f"brick shape {(bx, by, bz)} must be powers of "
                             "two >= 2")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"feats dtype {feats.dtype} not float32/bfloat16")
    if weights.dtype != feats.dtype:
        raise TypeError(f"weights dtype {weights.dtype} != feats dtype "
                        f"{feats.dtype}")
    if nbr.dtype != torch.int32 or occ.dtype != torch.bool:
        raise TypeError(f"nbr must be int32 and occ bool, got {nbr.dtype}, "
                        f"{occ.dtype}")
    if weights.dim() != 3 or weights.shape[:2] != (27, c):
        raise ValueError(f"weights must be (27, {c}, Cout), got "
                         f"{tuple(weights.shape)}")
    if tuple(nbr.shape) != (bm, 27):
        raise ValueError(f"nbr must be ({bm}, 27), got {tuple(nbr.shape)}")
    if tuple(occ.shape) != (bm, bx, by, bz):
        raise ValueError(f"occ must be {(bm, bx, by, bz)}, got "
                         f"{tuple(occ.shape)}")
    for name, t in (("feats", feats), ("nbr", nbr), ("weights", weights),
                    ("occ", occ)):
        if t.device != feats.device:
            raise ValueError(f"{name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bm * bx * by * bz >= 2 ** 31:
        raise ValueError("brick_conv3 indexes voxel rows in int32")
    return bm, bx, by, bz, c, weights.shape[2]


def brick_conv3(feats: torch.Tensor, nbr: torch.Tensor,
                weights: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """k3 submanifold brick conv: (Bm, bx,by,bz, C) -> (Bm, bx,by,bz, Cout),
    masked to ``occ``. nbr (Bm, 27) int32 (miss: any row outside [0, Bm)),
    weights (27, C, Cout) in the feats dtype. CUDA tensors run K1, CPU
    tensors the plain version."""
    if not feats.is_cuda:
        return brick_conv3_plain(feats, nbr, weights, occ)
    bm, bx, by, bz, c, cout = _check(feats, nbr, weights, occ)
    out = torch.empty((bm, bx, by, bz, cout), dtype=feats.dtype,
                      device=feats.device)
    if bm == 0 or cout == 0:
        return out
    if c == 0:
        return out.zero_()
    lib = LIB.load()
    with torch.cuda.device(feats.device):
        # occupied voxel rows first (ascending), then the empty ones, and
        # their count, all on the device: the kernel computes only the
        # occupied rows and writes zeros to the rest
        occ_flat = occ.reshape(-1)
        n_occ = occ_flat.sum(dtype=torch.int32)
        order = torch.argsort(torch.logical_not(occ_flat).to(torch.uint8),
                              stable=True).to(torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dropclip_brick_conv3(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            order.data_ptr(), n_occ.data_ptr(), out.data_ptr(), bm, bx, by,
            bz, c, cout, _DTYPES[feats.dtype], stream)
    LIB.check(err, "brick_conv3")
    brick_conv3.launches += 1
    return out


brick_conv3.launches = 0
