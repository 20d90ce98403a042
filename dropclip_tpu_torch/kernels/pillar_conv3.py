"""K2: the k3 submanifold pillar conv as a hand-written CUDA kernel.

Replaces ``dropclip_tpu/sparse/pallas_pillar.py::pallas_pillar_conv3``.
The source is ``csrc/pillar_conv3.cu`` on the tensor-core core it shares
with K1 (``csrc/sparse_conv3_mma.cuh``; design and bound in the header
notes); it is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at first use and loaded with ``ctypes``
(``kernels/nvcc.py``).

``pillar_conv3`` is the wrapper: it checks every shape, type, device and
contiguity the kernel needs (and raises on anything else, on every
device), then launches the kernel for CUDA tensors, or takes the plain
version, ``pillar_conv3_plain`` (a port of ``pallas_pillar.
pillar_conv3_xla``), for CPU tensors. ``pillar_conv3.launches`` counts
kernel launches. ``instance`` (K1's rule) picks the kernel's instance
from (dtype, C, Cout); ``row_order`` is its row schedule, torch ops on
any device, which a caller may compute once per level and pass in. The
TPU kernel's limits (Z a multiple of 8, C and Cout multiples of 128, P a
multiple of the pillar tile, output chunks of 8192 pillars) were
Mosaic's and do not apply.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..sparse.pillar_ops import gather_rows, z_shift
from . import count_launch
from .brick_conv3 import KINDS, instance
from .nvcc import library

# xy-direction order: dx-major, dy-minor, both ascending; index 4 is the
# pillar itself (nbr[:, 4] == row in a well-formed table).
PILLAR_DIRS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

_DTYPES = (torch.float32, torch.bfloat16)
TILE = 128  # the kernel's output tile: rows and channels
SPLIT_TILES_PER_SM = 2  # K is split only where the tiles fit the scratch
Schedule = Tuple[torch.Tensor, torch.Tensor]


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dropclip_pillar_conv3.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i,
                                          i, i, i, i, i, i, p]
    lib.dropclip_pillar_conv3.restype = i


LIB = library("pillar_conv3", _bind)


def pillar_conv3_plain(feats: torch.Tensor, nbr: torch.Tensor,
                       weights: torch.Tensor, occ: torch.Tensor,
                       scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2 (``pillar_conv3_xla``): gather the 9
    neighbour columns, three z-shifted products in float32, then
    ``occ * relu?(y * scale + bias)`` (no affine step without scale and
    bias), cast to the feats dtype."""
    cols = gather_rows(feats, nbr).float()  # (P, 9, Z, C)
    w = weights.float()
    y = sum(torch.einsum("pjzc,jco->pzo", z_shift(cols, dzi - 1), w[:, dzi])
            for dzi in range(3))
    if scale is not None:
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
    if (scale is None) != (bias is None):
        raise ValueError("give both scale and bias, or neither")
    affine = () if scale is None else (("scale", scale), ("bias", bias))
    if any(t.dtype != torch.float32 for _, t in affine):
        raise TypeError("scale and bias must be float32")
    if weights.dim() != 4 or tuple(weights.shape[:3]) != (9, 3, c):
        raise ValueError(f"weights must be (9, 3, {c}, Cout), got "
                         f"{tuple(weights.shape)}")
    cout = weights.shape[3]
    if tuple(nbr.shape) != (p, 9):
        raise ValueError(f"nbr must be ({p}, 9), got {tuple(nbr.shape)}")
    if tuple(occ.shape) != (p, z):
        raise ValueError(f"occ must be ({p}, {z}), got {tuple(occ.shape)}")
    if any(tuple(t.shape) != (cout,) for _, t in affine):
        raise ValueError(f"scale and bias must be ({cout},), got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    for name, t in (("feats", feats), ("nbr", nbr), ("weights", weights),
                    ("occ", occ)) + affine:
        if t.device != feats.device:
            raise ValueError(f"{name} on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p * z >= 2 ** 31:
        raise ValueError("pillar_conv3 indexes (pillar, z) slots in int32")
    return p, z, c, cout


def row_order(occ: torch.Tensor) -> Schedule:
    """K2's row schedule, on the device of ``occ`` with no host sync:
    ``order``, the occupied (pillar, z) slots ascending and then the empty
    ones ascending (P*Z int32), and ``n_occ``, their count (int32 scalar
    tensor). The kernel computes the first ``n_occ`` rows and writes zeros
    to the rest."""
    flat = occ.reshape(-1)
    order = torch.sort(flat, descending=True, stable=True).indices
    return order.to(torch.int32), flat.sum(dtype=torch.int32)


_SCRATCH: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor,
                                                int]] = {}


def _scratch(device: torch.device, stream: int
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The split path's float32 sums (one 128 x 128 tile per output tile,
    for up to two per SM) and tile counts, allocated zero once per device
    and stream; the kernel leaves them zero. Also the device's SM
    count."""
    key = (device, stream)
    if key not in _SCRATCH:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _SCRATCH[key] = (
            torch.zeros((SPLIT_TILES_PER_SM * n_sm, TILE, TILE),
                        dtype=torch.float32, device=device),
            torch.zeros(SPLIT_TILES_PER_SM * n_sm, dtype=torch.int32,
                        device=device), n_sm)
    return _SCRATCH[key]


def pillar_conv3(feats: torch.Tensor, nbr: torch.Tensor,
                 weights: torch.Tensor, occ: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None, relu: bool = True,
                 schedule: Optional[Schedule] = None) -> torch.Tensor:
    """Fused k3 submanifold pillar conv + folded-BN epilogue:
    ``occ * relu?(conv3(feats) * scale + bias)`` in the feats dtype.

    feats (P, Z, C) float32 or bfloat16; nbr (P, 9) int32 xy-neighbours in
    ``PILLAR_DIRS`` order (miss: any row outside [0, P)); weights
    (9, 3, C, Cout) in the feats dtype, dz ascending; occ (P, Z) bool;
    scale and bias (Cout,) float32, or both None for no affine step. CUDA
    tensors run K2, CPU tensors the plain version.

    ``schedule``: ``row_order(occ)`` of this very ``occ``, which a caller
    may compute once per level and share between convs; only its shapes,
    dtypes and device are checked (the rest needs a host sync). K2 reads
    every source that exists, so the features need not vanish off
    ``occ``. Without a schedule the wrapper computes it.
    """
    p, z, c, cout = _check(feats, nbr, weights, occ, scale, bias)
    if schedule is not None:
        order, n_occ = schedule
        if (order.shape != (p * z,) or n_occ.numel() != 1 or any(
                t.dtype != torch.int32 or t.device != feats.device
                for t in schedule)):
            raise ValueError("schedule must be row_order(occ) of this occ")
    if not feats.is_cuda:
        return pillar_conv3_plain(feats, nbr, weights, occ, scale, bias,
                                  relu)
    out = torch.empty((p, z, cout), dtype=feats.dtype, device=feats.device)
    if p * z == 0 or cout == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(feats.device):
        if schedule is None:
            schedule = row_order(occ)
        order, n_occ = schedule
        stream = torch.cuda.current_stream().cuda_stream
        sums, counts, n_sm = _scratch(feats.device, stream)
        aligned = feats.data_ptr() % 16 == 0 and \
            weights.data_ptr() % 16 == 0
        kind = KINDS[instance(feats.dtype, c, cout, aligned)]
        err = lib.dropclip_pillar_conv3(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            order.data_ptr(), n_occ.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), p, z, c, cout, int(relu),
            kind, n_sm, counts.numel(), stream)
    LIB.check(err, "pillar_conv3")
    count_launch(pillar_conv3)
    return out


pillar_conv3.launches = 0
