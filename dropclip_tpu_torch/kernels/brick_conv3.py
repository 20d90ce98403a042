"""K1: the k3 submanifold brick conv as a hand-written CUDA kernel.

Replaces ``dropclip_tpu/sparse/pallas_conv.py::pallas_brick_conv3``. The
source is ``csrc/brick_conv3.cu`` (design and bound in its header note);
it is compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at
first use and loaded with ``ctypes`` (``kernels/nvcc.py``).

``brick_conv3`` is the wrapper: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it takes the plain version,
``brick_conv3_plain`` (``sparse.bricks.brick_conv`` with ksize 3).
``counter.launches`` counts kernel launches. ``instance`` picks the
kernel's instance from (dtype, C, Cout); ``row_order`` is its row
schedule (occupied rows sorted by their 27-bit tap mask, ``tap_masks``),
torch ops on any device, which a caller may compute once per level and
pass in.

``BrickConv3Fn`` makes the conv differentiable for the trainer: the
input gradient is itself a k3 submanifold conv on the same level (tap k
reads weight 26-k transposed), so K1 computes it too; the weight gradient
is a gathered product over the occupied rows (``brick_conv3_wgrad``,
torch matmuls, as the JAX package leaves it to XLA).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from ..sparse.bricks import BrickLevel, brick_conv
from .nvcc import library

_DTYPES = (torch.float32, torch.bfloat16)
# instance name -> the ``kind`` argument of dropclip_brick_conv3
KINDS = {"tf32x3": 0, "tf32x3_ragged": 1, "bf16": 2, "bf16_ragged": 3}
# K1 launches, counted where ``brick_conv3`` launches the kernel; the count
# lives here, not on the function, so a caller that wraps or swaps
# ``brick_conv3`` leaves it in place
counter = SimpleNamespace(launches=0)


def instance(dtype: torch.dtype, c: int, cout: int,
             aligned: bool = True) -> str:
    """The kernel instance that takes (dtype, C, Cout), all on the tensor
    cores: float32 through 3xTF32 on mma.sync ("tf32x3"), bfloat16 on
    wgmma ("bf16"). Both fill shared memory with 16-byte copies when C and
    Cout are multiples of 16 bytes' worth of elements (4 float32, 8
    bfloat16) and the tensors are 16-byte aligned, else element by element
    on the same products (the "_ragged" instances, e.g. C = 3). Raises
    TypeError for any other dtype."""
    if dtype not in _DTYPES:
        raise TypeError(f"feats dtype {dtype} not float32/bfloat16")
    name = "tf32x3" if dtype == torch.float32 else "bf16"
    per16 = 16 // (4 if dtype == torch.float32 else 2)
    vec = aligned and c % per16 == 0 and cout % per16 == 0
    return name if vec else name + "_ragged"


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dropclip_brick_conv3.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         i, i, p]
    lib.dropclip_brick_conv3.restype = i


LIB = library("brick_conv3", _bind)


def brick_conv3_plain(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, occ: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of K1 (halo gather + 27-tap matmul)."""
    level = BrickLevel(coords=None, keys=None, mask=None, occ=occ, nbr=nbr)
    return brick_conv(feats, level, weights, ksize=3)


_TAP_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tap_tables(bshape: Tuple[int, int, int], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``source[v, t]``: where the tap-t source of voxel v of a brick lies,
    as ``direction * bx*by*bz + voxel``, with ``direction`` the column of
    ``nbr`` (lexicographic (dx, dy, dz)) and ``voxel`` the row-major slot
    within that brick; and ``bit[t] = 1 << t``. Built once per brick shape
    and device."""
    key = (tuple(bshape), str(device))
    if key not in _TAP_TABLES:
        ext = torch.tensor(bshape)
        axes = [torch.arange(n) for n in bshape]
        vox = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
        off = torch.stack(torch.meshgrid(*[torch.arange(-1, 2)] * 3,
                                         indexing="ij"), -1)
        p = vox.reshape(-1, 1, 3) + off.reshape(1, 27, 3)
        d = (p >= ext).long() - (p < 0).long()
        q = p - d * ext
        direction = (d[..., 0] + 1) * 9 + (d[..., 1] + 1) * 3 + d[..., 2] + 1
        within = (q[..., 0] * bshape[1] + q[..., 1]) * bshape[2] + q[..., 2]
        bit = torch.ones(27, dtype=torch.int32) << torch.arange(
            27, dtype=torch.int32)
        _TAP_TABLES[key] = ((direction * int(ext.prod()) + within).to(device),
                            bit.to(device))
    return _TAP_TABLES[key]


def tap_masks(live: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(Bm, bx, by, bz) int32 of 27-bit masks: bit t is set where the
    tap-t source of a voxel lies in a brick that exists (``nbr`` in [0,
    Bm)) and is ``live`` there. ``live`` (Bm, bx, by, bz) bool: the
    voxels whose features may be nonzero."""
    bm, bx, by, bz = live.shape
    v = bx * by * bz
    source, bit = _tap_tables((bx, by, bz), live.device)
    # a miss (-1 or Bm after the clamp) reads the zero row at the end
    padded = torch.cat([live.reshape(bm, v), live.new_zeros((1, v))])
    near = padded[nbr.long().clamp(-1, bm)].reshape(bm, 27 * v)
    return (near[:, source] * bit).sum(-1, dtype=torch.int32).reshape(
        bm, bx, by, bz)


def row_order(occ: torch.Tensor, nbr: torch.Tensor,
              live: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's row schedule, on the device of ``occ`` with no host sync:
    ``order``, the occupied voxel rows sorted by (tap mask, row) and then
    the empty rows ascending (Bm*bx*by*bz int32); ``n_occ``, their count
    (int32 scalar tensor); ``masks``, every row's tap mask
    (``tap_masks(live, nbr)`` flattened; ``live`` defaults to ``occ``).
    Rows with one mask share a 128-row tile, so a tile's union of masks,
    the taps it computes, stays small."""
    masks = tap_masks(occ if live is None else live, nbr).reshape(-1)
    occ_flat = occ.reshape(-1)
    key = torch.where(occ_flat, masks, 1 << 27)
    order = torch.argsort(key, stable=True).to(torch.int32)
    return order, occ_flat.sum(dtype=torch.int32), masks


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
                weights: torch.Tensor, occ: torch.Tensor,
                schedule: Optional[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]] = None
                ) -> torch.Tensor:
    """k3 submanifold brick conv: (Bm, bx,by,bz, C) -> (Bm, bx,by,bz, Cout),
    masked to ``occ``. nbr (Bm, 27) int32 (miss: any row outside [0, Bm)),
    weights (27, C, Cout) in the feats dtype. CUDA tensors run K1, CPU
    tensors the plain version.

    ``schedule``: ``row_order(occ, nbr)`` of this very level, which a
    caller may compute once and share between convs. Contract, which the
    wrapper cannot check without a host sync: ``feats`` is zero at every
    voxel outside ``occ`` (the brick student's convs keep it, since every
    input is masked to ``occ``), because K1 reads no source outside
    ``occ`` and a schedule of another level gives wrong sums; only the
    shapes, dtypes and device are checked. Without a schedule the wrapper
    orders the rows itself and takes a source as live where its features
    are not all zero, which holds for any input."""
    if not feats.is_cuda:
        return brick_conv3_plain(feats, nbr, weights, occ)
    bm, bx, by, bz, c, cout = _check(feats, nbr, weights, occ)
    if schedule is not None:
        rows = bm * bx * by * bz
        order, n_occ, masks = schedule
        if (order.shape != (rows,) or masks.shape != (rows,)
                or n_occ.numel() != 1 or any(
                    t.dtype != torch.int32 or t.device != feats.device
                    for t in schedule)):
            raise ValueError("schedule must be row_order(occ, nbr) of this "
                             "level")
    out = torch.empty((bm, bx, by, bz, cout), dtype=feats.dtype,
                      device=feats.device)
    if bm == 0 or cout == 0:
        return out
    if c == 0:
        return out.zero_()
    lib = LIB.load()
    with torch.cuda.device(feats.device):
        if schedule is None:
            # a source whose features are all zero adds nothing to any sum
            schedule = row_order(occ, nbr, feats.any(-1))
        order, n_occ, masks = schedule
        aligned = feats.data_ptr() % 16 == 0 and \
            weights.data_ptr() % 16 == 0
        kind = KINDS[instance(feats.dtype, c, cout, aligned)]
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dropclip_brick_conv3(
            feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
            order.data_ptr(), n_occ.data_ptr(), masks.data_ptr(),
            out.data_ptr(), bm, bx, by, bz, c, cout, kind, stream)
    LIB.check(err, "brick_conv3")
    counter.launches += 1
    return out


def tap_sources(nbr: torch.Tensor, bshape: Tuple[int, int, int],
                rows: torch.Tensor) -> torch.Tensor:
    """(n, 27) int64: the flat voxel row that tap t of each voxel row in
    ``rows`` reads (``nbr``'s brick times bx*by*bz plus the slot within
    it), or Bm*bx*by*bz, one past the last row, where the neighbour brick
    does not exist."""
    bm = nbr.shape[0]
    bv = int(np.prod(bshape))
    source, _ = _tap_tables(tuple(bshape), nbr.device)
    s = source[rows % bv]
    brick = nbr.long()[(rows // bv)[:, None], s // bv]
    hit = (brick >= 0) & (brick < bm)
    return torch.where(hit, brick * bv + s % bv, bm * bv)


# bytes of gathered float32 sources per wgrad product
_WGRAD_CHUNK_BYTES = 1 << 29


def brick_conv3_wgrad(feats: torch.Tensor, grad_out: torch.Tensor,
                      nbr: torch.Tensor, occ: torch.Tensor,
                      schedule: Optional[Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Weight gradient of the k3 conv, float32 (27, C, Cout):
    dW[t] = sum over occupied rows i of X[src_t(i)]^T . dY[i], where
    ``grad_out`` is zero off ``occ``. The occupied rows are the
    schedule's first ``n_occ`` entries, or ``occ``'s nonzeros; either
    reads a count back to the host. The gathered sources go a few taps
    at a time (at most ``_WGRAD_CHUNK_BYTES``), never all 27 unfolded:
    at level 0 of the full student that would be 327,680 x 27 x 416 x 4
    bytes = 14.7 GB."""
    bm, bx, by, bz, c = feats.shape
    cout = grad_out.shape[-1]
    if schedule is not None:
        rows = schedule[0][: int(schedule[1])].long()
    else:
        rows = occ.reshape(-1).nonzero()[:, 0]
    n = rows.numel()
    src = tap_sources(nbr, (bx, by, bz), rows)
    x = torch.cat([feats.reshape(-1, c), feats.new_zeros((1, c))]).float()
    g = grad_out.reshape(-1, cout)[rows].float()
    dw = torch.empty((27, c, cout), dtype=torch.float32, device=feats.device)
    step = max(1, min(27, _WGRAD_CHUNK_BYTES // max(n * c * 4, 1)))
    for t0 in range(0, 27, step):
        t1 = min(27, t0 + step)
        xs = x[src[:, t0:t1]].reshape(n, (t1 - t0) * c)
        dw[t0:t1] = (xs.T @ g).reshape(t1 - t0, c, cout)
    return dw


def mirror_taps(weights: torch.Tensor) -> torch.Tensor:
    """(27, C, Cout) -> (27, Cout, C), tap k taking weight 26-k
    transposed: the dgrad conv's weights."""
    return weights.flip(0).transpose(1, 2).contiguous()


class BrickConv3Fn(torch.autograd.Function):
    """The k3 submanifold brick conv under autograd:
    ``BrickConv3Fn.apply(feats, weights, nbr, occ, schedule)``.

    - forward: ``brick_conv3`` (K1 on a CUDA tensor, the plain version on
      a CPU tensor);
    - input gradient (dgrad): ``brick_conv3`` of ``dY * occ`` with the
      weights ``w.flip(0).transpose(1, 2)``, on the same ``nbr``, ``occ``
      and schedule: in ``_NBR_OFFSETS``' lexicographic order offset 26-k
      is -offset k, so dX[j] = sum_k dY[j + o_k] . W[26-k]^T. The schedule
      stays valid because ``dY * occ`` is zero off ``occ``, as the
      forward's input is. K1 on the card: no other kernel, no fallback;
    - weight gradient (wgrad): ``brick_conv3_wgrad`` over the occupied
      rows, cast to the weights' dtype.

    dX is exact on occupied voxels and zero elsewhere, since K1 masks its
    output to ``occ``; the true gradient is also nonzero at empty voxels
    next to occupied ones. That is right for a caller whose conv input is
    already multiplied by this level's occupancy, so that no gradient
    reaches anything through an empty voxel: in the brick student every
    k3 conv input is a ``MaskedBatchNorm`` output, the relu of one, or
    the decoder's ``torch.cat`` of two, all masked to the level's
    ``occ``.
    """

    @staticmethod
    def forward(ctx, feats, weights, nbr, occ, schedule=None):
        ctx.save_for_backward(feats, weights, nbr, occ)
        ctx.schedule = schedule
        return brick_conv3(feats, nbr, weights, occ, schedule)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        feats, weights, nbr, occ = ctx.saved_tensors
        dy = (grad_out * occ[..., None].to(grad_out.dtype)).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = brick_conv3(dy, nbr, mirror_taps(weights), occ,
                             ctx.schedule)
        if ctx.needs_input_grad[1]:
            dw = brick_conv3_wgrad(feats, dy, nbr, occ,
                                   ctx.schedule).to(weights.dtype)
        return dx, dw, None, None, None
