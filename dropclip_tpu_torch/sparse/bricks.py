"""Brick-dense sparse-voxel engine as torch ops on the pipeline's device.

Port of ``dropclip_tpu/sparse/bricks.py``. The voxel set is stored as
occupied bricks of shape (bx, by, bz) (powers of two >= 2):

- features live dense per brick, (Bm, bx, by, bz, C), with a voxel
  occupancy mask (absent voxels hold zeros: submanifold semantics);
- the topology is brick-level only: the occupied brick cells in sorted
  order (a brick's row is its cell's rank, as in the JAX package's dense
  rank table), the 27-neighbour brick rows, and the 2x2x2 group /
  parent maps between pyramid levels;
- stride-1 convs gather a halo around every brick and run the taps as
  matmuls; the k3 case is the plain version of the CUDA kernel
  ``kernels/brick_conv3.py`` (K1), which serves every k3 conv on the card;
- the k2s2 convs' and the points' row gathers, where autograd records
  them, take backwards that read through the topology's inverse maps
  (the group map and the parent map with its octants), not autograd's
  sort-based backward of the indexing.

The topology builder is batched natively (leading scene axis) where the
JAX package vmaps; ``fold_topology`` then folds scenes into one brick
axis, as the JAX engine's single-device path does. Index tensors are
int32 like the JAX package's; ``dropped`` counts voxels (level 0) and
fine bricks (levels > 0) that capacity or grid extent truncated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.spans import span

DEFAULT_BRICK_SHAPE = (4, 4, 4)


def _shifts(bshape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    for s in bshape:
        # >= 2 because the transposed conv halves each brick axis and the
        # k5 stem needs pad 2
        if s < 2 or s & (s - 1):
            raise ValueError(
                f"brick shape {bshape} must be powers of two >= 2")
    return tuple(s.bit_length() - 1 for s in bshape)


class BrickLevel(NamedTuple):
    coords: torch.Tensor  # (..., Bm, 3) int32 brick grid coords
    keys: torch.Tensor    # (..., Bm) int32 dense cell ids
    mask: torch.Tensor    # (..., Bm) bool occupied brick
    occ: torch.Tensor     # (..., Bm, bx, by, bz) bool voxel occupancy
    nbr: torch.Tensor     # (..., Bm, 27) int32 neighbour rows (miss -> Bm)


class BrickTopology(NamedTuple):
    """Index structure for one UNet forward over brick levels."""

    levels: Tuple[BrickLevel, ...]
    point_row: torch.Tensor     # (..., M) level-0 brick row per voxel
    point_within: torch.Tensor  # (..., M) within-brick flat offset
    group_maps: Tuple[torch.Tensor, ...]   # (..., Bm_{l+1}, 8) fine rows
    parent_maps: Tuple[torch.Tensor, ...]  # (..., Bm_l) coarse row per fine
    octants: Tuple[torch.Tensor, ...]      # (..., Bm_l, 3) fine brick & 1
    dropped: Optional[torch.Tensor] = None  # (..., L) truncated units
    # per level, a static bound on the occupied voxel rows (set by a
    # scanned trainer from its staged data), which the k3 convs' weight
    # gradients take instead of reading the count back to the host
    wgrad_rows: Optional[Tuple[int, ...]] = None


class _GridLevel(NamedTuple):
    level: BrickLevel
    table: torch.Tensor  # (B, cap) occupied cell ids, ascending (pad: cells)
    gdims: Tuple[int, int, int]
    bias: Tuple[int, int, int]


def _n_cells(gdims: Tuple[int, int, int]) -> int:
    return gdims[0] * gdims[1] * gdims[2]


def _rows_of(table: torch.Tensor, cells: torch.Tensor,
             n_cells: int) -> torch.Tensor:
    """Brick row of each cell id: its place in the level's sorted
    ``table`` of occupied cells (B, cap), or cap where the cell holds no
    brick of the level (empty, past capacity, or the guard ``n_cells``)."""
    cap = table.shape[1]
    idx = torch.searchsorted(table, cells)
    hit = torch.gather(table, 1, idx.clamp(max=cap - 1)) == cells
    return torch.where(hit & (cells < n_cells), idx, cap)


def _grid_level(cells: torch.Tensor, capacity: int,
                gdims: Tuple[int, int, int], bias: Tuple[int, int, int],
                bshape: Tuple[int, int, int]) -> _GridLevel:
    """cells: (B, N) int64 dense cell ids of occupied bricks (guard
    gx*gy*gz for invalid) -> brick level (occ filled by the caller).

    A brick's row is the rank of its cell among the scene's occupied
    cells, as in the JAX package's dense rank table; here the ranks come
    from sorting the cells, so memory follows the bricks, not the grid."""
    b = cells.shape[0]
    dev = cells.device
    gx, gy, gz = gdims
    n_cells = gx * gy * gz
    srt = torch.sort(cells, dim=1).values
    head = srt < n_cells
    head[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(head, dim=1) - 1
    n = head.sum(1)
    dst = torch.where(head & (rank < capacity), rank, capacity)
    brick_cell = torch.zeros((b, capacity + 1), dtype=torch.int64, device=dev)
    brick_cell.scatter_(1, dst, srt)  # guard col dropped
    brick_cell = brick_cell[:, :capacity]
    bmask = (torch.arange(capacity, device=dev)[None]
             < torch.clamp(n, max=capacity)[:, None])
    table = torch.where(bmask, brick_cell, n_cells).contiguous()
    cx = brick_cell // (gy * gz)
    cy = (brick_cell // gz) % gy
    cz = brick_cell % gz
    coords = torch.stack([cx - bias[0], cy - bias[1], cz - bias[2]], -1)
    coords = torch.where(bmask[..., None], coords, 0)

    offs = _offsets(3, dev) - 1
    nbc = (torch.stack([coords[..., a] + bias[a] for a in range(3)], -1)
           [:, :, None, :] + offs[None, None])
    ok = _in_grid(nbc, gdims) & bmask[..., None]
    ncell = (nbc[..., 0] * gy + nbc[..., 1]) * gz + nbc[..., 2]
    ncell = torch.where(ok, ncell, n_cells)
    nbr = _rows_of(table, ncell.reshape(b, -1), n_cells).reshape(
        b, capacity, 27)

    lvl = BrickLevel(
        coords=coords.int(), keys=brick_cell.int(), mask=bmask,
        occ=torch.zeros((b, capacity) + tuple(bshape), dtype=torch.bool,
                        device=dev),
        nbr=nbr.int())
    return _GridLevel(level=lvl, table=table, gdims=gdims, bias=bias)


def _offsets(n: int, device: torch.device) -> torch.Tensor:
    """(n**3, 3) int64 offsets in {0..n-1}^3, lexicographic (the last axis
    fastest), made on ``device`` by device ops: a copy to the card is not
    allowed in the middle of a captured CUDA graph. ``_offsets(3) - 1``,
    (dx, dy, dz) in {-1, 0, 1}^3, is the weight order of every k3 kernel,
    (K, Cin, Cout); ``_offsets(2)`` that of the k2s2 convs."""
    r = torch.arange(n, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


def _in_grid(c: torch.Tensor, gdims: Tuple[int, int, int]) -> torch.Tensor:
    """(..., 3) grid coords -> (...) bool: inside [0, gdims) on every
    axis."""
    ok = (c >= 0).all(-1)
    for a in range(3):
        ok = ok & (c[..., a] < gdims[a])
    return ok


def _cells_of(bcoords: torch.Tensor, valid: torch.Tensor,
              gdims: Tuple[int, int, int],
              bias: Tuple[int, int, int]) -> torch.Tensor:
    gx, gy, gz = gdims
    bc = torch.stack([bcoords[..., a].long() + bias[a] for a in range(3)],
                     -1)
    ok = valid & _in_grid(bc, gdims)
    cell = (bc[..., 0] * gy + bc[..., 1]) * gz + bc[..., 2]
    return torch.where(ok, cell, gx * gy * gz)


def _build_batched(coords: torch.Tensor, mask: torch.Tensor,
                   num_levels: int, grid_bits: int,
                   capacities: Tuple[int, ...],
                   bshape: Tuple[int, int, int]) -> BrickTopology:
    sx, sy, sz = _shifts(bshape)
    bx, by, bz = bshape
    bv = bx * by * bz
    b = coords.shape[0]
    dev = coords.device
    coords = coords.long()
    # the VOXEL extent is 2^(grid_bits+2) on every axis whatever the brick
    # shape: an axis with smaller bricks gets proportionally more of them
    g0dims = tuple(((1 << grid_bits) * 4) // s for s in bshape)
    offs8 = _offsets(2, dev)

    levels, grids = [], []
    group_maps, parent_maps, octants, dropped = [], [], [], []
    for l in range(num_levels):
        gdims = tuple(max(gd >> l, 2) for gd in g0dims)
        bias = tuple(gd // 2 for gd in gdims)
        cap = capacities[l]
        if l == 0:
            bcoord = torch.stack([coords[..., 0] >> sx, coords[..., 1] >> sy,
                                  coords[..., 2] >> sz], dim=-1)
            cells = _cells_of(bcoord, mask, gdims, bias)
            gl = _grid_level(cells, cap, gdims, bias, bshape)
            row0 = _rows_of(gl.table, cells, _n_cells(gdims))
            kept = mask & (row0 < cap)
            dropped.append((mask & (row0 >= cap)).sum(1))
            w0 = (((coords[..., 0] & (bx - 1)) * by
                   + (coords[..., 1] & (by - 1))) * bz
                  + (coords[..., 2] & (bz - 1)))
            w0 = torch.where(kept, w0, 0)
            dst = torch.where(kept, row0 * bv + w0, cap * bv)
            occ = torch.zeros((b, cap * bv + 1), dtype=torch.bool, device=dev)
            occ.scatter_(1, dst, True)
            occ = occ[:, :-1].reshape(b, cap, bx, by, bz)
            gl = gl._replace(level=gl.level._replace(occ=occ))
        else:
            fine_gl, fine = grids[-1], levels[-1]
            fcells = _cells_of(fine.coords >> 1, fine.mask, gdims, bias)
            gl = _grid_level(fcells, cap, gdims, bias, bshape)
            pmap = _rows_of(gl.table, fcells, _n_cells(gdims))
            parent_maps.append(pmap.int())
            dropped.append((fine.mask & (pmap >= cap)).sum(1))
            octants.append(torch.where(fine.mask[..., None], fine.coords & 1,
                                       0).int())
            # group map: coarse brick -> its 2x2x2 fine bricks
            child = gl.level.coords[:, :, None, :].long() * 2 + offs8
            ccells = _cells_of(child, gl.level.mask[:, :, None],
                               fine_gl.gdims, fine_gl.bias)
            gmap = _rows_of(fine_gl.table, ccells.reshape(b, -1),
                            _n_cells(fine_gl.gdims)).reshape(b, cap, 8)
            group_maps.append(gmap.int())
            # coarse voxel occupancy: any of its 8 fine voxels occupied
            occ_pad = torch.cat(
                [fine.occ, torch.zeros((b, 1, bx, by, bz), dtype=torch.bool,
                                       device=dev)], dim=1)
            grp = occ_pad[torch.arange(b, device=dev)[:, None, None], gmap]
            grp = grp.reshape(b, cap, 2, 2, 2, bx, by, bz).permute(
                0, 1, 2, 5, 3, 6, 4, 7).reshape(b, cap, 2 * bx, 2 * by, 2 * bz)
            cocc = grp.reshape(b, cap, bx, 2, by, 2, bz, 2).any(7).any(5).any(3)
            gl = gl._replace(level=gl.level._replace(
                occ=cocc & gl.level.mask[..., None, None, None]))
        levels.append(gl.level)
        grids.append(gl)

    return BrickTopology(levels=tuple(levels), point_row=row0.int(),
                         point_within=w0.int(), group_maps=tuple(group_maps),
                         parent_maps=tuple(parent_maps),
                         octants=tuple(octants),
                         dropped=torch.stack(dropped, -1).int())


def build_brick_topology(coords: torch.Tensor, mask: torch.Tensor,
                         num_levels: int = 5, grid_bits: int = 5,
                         brick_capacities: Optional[Sequence[int]] = None,
                         brick_shape: Tuple[int, int, int] =
                         DEFAULT_BRICK_SHAPE) -> BrickTopology:
    """Voxel coords (B, M, 3)/(M, 3) -> brick topology pyramid on the
    coords' device.

    ``grid_bits``: level-0 voxel extent is ±2^(grid_bits+1) on every axis;
    voxels outside are dropped and counted in ``dropped[..., 0]`` with
    capacity overflow (``grid_bits_for`` gives the grid that holds them
    all); the grid's cell ids must fit int32. Default brick capacities:
    M//8 at level 0, halving per level with a floor of 32.
    """
    bshape = tuple(int(s) for s in brick_shape)
    if (1 << (grid_bits + 2)) ** 3 // int(np.prod(bshape)) > 2 ** 31:
        raise ValueError(f"grid_bits {grid_bits} at bricks {bshape}: the "
                         "grid's cell ids do not fit int32")
    batched = coords.dim() == 3
    if not batched:
        coords, mask = coords[None], mask[None]
    m = coords.shape[-2]
    if brick_capacities is None:
        b0 = max(m // 8, 32)
        brick_capacities = tuple(max(b0 >> l, 32) for l in range(num_levels))
    topo = _build_batched(coords, mask.bool(), num_levels, grid_bits,
                          tuple(int(c) for c in brick_capacities), bshape)
    if batched:
        return topo
    strip = lambda t: t[0]
    return BrickTopology(
        levels=tuple(BrickLevel(*map(strip, lv)) for lv in topo.levels),
        point_row=strip(topo.point_row), point_within=strip(topo.point_within),
        group_maps=tuple(map(strip, topo.group_maps)),
        parent_maps=tuple(map(strip, topo.parent_maps)),
        octants=tuple(map(strip, topo.octants)), dropped=strip(topo.dropped))


def grid_bits_for(coords: torch.Tensor, mask: torch.Tensor,
                  floor: int = 5) -> int:
    """The smallest ``grid_bits`` >= ``floor`` whose extent,
    [-2^(grid_bits+1), 2^(grid_bits+1)) voxels on every axis, holds every
    masked voxel of ``coords`` (one read of two numbers from the device).
    Where the floor's extent holds them, the topology equals the floor's;
    a larger grid only numbers the same bricks' cells further apart."""
    c = torch.where(mask.bool()[..., None], coords, 0)
    if c.numel() == 0:
        return floor
    lo, hi = torch.aminmax(c)
    with span("sync.grid_bits"):
        lo = int(lo)
    with span("sync.grid_bits"):
        hi = int(hi)
    extent = max(-lo, hi + 1, 1)
    return max(floor, (extent - 1).bit_length() - 1)


def fold_topology(topo: BrickTopology) -> BrickTopology:
    """Fold the batch axis into the brick axis: (B, Bm, ...) levels ->
    (B*Bm, ...) with every index map globalized (row + b*cap, miss ->
    B*cap, the one shared zero row). Scenes cannot mix: a scene's
    globalized indices stay inside its own row block."""
    b = topo.point_row.shape[0]

    def fold(a):
        return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))

    def gidx(idx, cap):
        off = (torch.arange(b, device=idx.device, dtype=idx.dtype) * cap
               ).reshape((b,) + (1,) * (idx.dim() - 1))
        return fold(torch.where(idx >= cap, b * cap, idx + off))

    caps = [lvl.occ.shape[1] for lvl in topo.levels]
    levels = tuple(
        BrickLevel(coords=fold(lvl.coords), keys=fold(lvl.keys),
                   mask=fold(lvl.mask), occ=fold(lvl.occ),
                   nbr=gidx(lvl.nbr, caps[l]))
        for l, lvl in enumerate(topo.levels))
    return BrickTopology(
        levels=levels,
        point_row=gidx(topo.point_row, caps[0]),
        point_within=fold(topo.point_within),
        # group_maps[l]: level l+1 bricks -> level l rows (caps[l]);
        # parent_maps[l]: level l bricks -> level l+1 rows (caps[l+1])
        group_maps=tuple(gidx(g, caps[l])
                         for l, g in enumerate(topo.group_maps)),
        parent_maps=tuple(gidx(p, caps[l + 1])
                          for l, p in enumerate(topo.parent_maps)),
        octants=tuple(fold(o) for o in topo.octants),
        dropped=topo.dropped,
        wgrad_rows=topo.wgrad_rows)


def autotune_brick_capacities(coords, mask, num_levels: int = 5,
                              slack: float = 1.2, multiple: int = 64,
                              floor: int = 32,
                              brick_shape: Tuple[int, int, int] =
                              DEFAULT_BRICK_SHAPE) -> Tuple[int, ...]:
    """Per-level occupied-brick counts on sample scenes (host, numpy) ->
    padded static capacities for ``build_brick_topology``: the worst
    scene's count times ``slack``, rounded up to ``multiple``."""
    coords = np.asarray(coords)
    mask = np.asarray(mask)
    if coords.ndim == 2:
        coords, mask = coords[None], mask[None]
    caps = []
    sx, sy, sz = _shifts(tuple(brick_shape))
    bricks = np.stack([coords[..., 0] >> sx, coords[..., 1] >> sy,
                       coords[..., 2] >> sz], axis=-1)
    for _ in range(num_levels):
        worst = 1
        for b in range(coords.shape[0]):
            worst = max(worst, len(np.unique(bricks[b][mask[b]], axis=0)))
        cap = int(np.ceil(worst * slack / multiple) * multiple)
        caps.append(max(cap, floor))
        bricks = bricks >> 1
    return tuple(caps)


# --------------------------------------------------------------- feature ops

def scatter_points(feats: torch.Tensor, row: torch.Tensor,
                   within: torch.Tensor, capacity: int,
                   brick_shape: Tuple[int, int, int] = DEFAULT_BRICK_SHAPE
                   ) -> torch.Tensor:
    """(M, C) voxel features -> (Bm, bx, by, bz, C) brick-dense."""
    bx, by, bz = brick_shape
    bv = bx * by * bz
    flat = feats.new_zeros((capacity * bv + 1, feats.shape[-1]))
    row, within = row.long(), within.long()
    dst = torch.where(row < capacity, row * bv + within, capacity * bv)
    flat[dst] = feats  # padded rows all land on the dropped guard row
    return flat[:-1].reshape(capacity, bx, by, bz, feats.shape[-1])


def gather_points(dense: torch.Tensor, row: torch.Tensor,
                  within: torch.Tensor) -> torch.Tensor:
    """(Bm, bx, by, bz, C) -> (M, C) at the given voxel slots (pad ->
    zeros)."""
    bm, bx, by, bz, c = dense.shape
    bv = bx * by * bz
    if _wants_grad(dense):
        return _PointGather.apply(dense, row.long(), within.long())
    flat = torch.cat([dense.reshape(bm * bv, c), dense.new_zeros((1, c))])
    row, within = row.long(), within.long()
    src = torch.where(row < bm, row * bv + within, bm * bv)
    return flat[src]


def halo_exchange(feats: torch.Tensor, nbr: torch.Tensor,
                  pad: int = 1) -> torch.Tensor:
    """(Bm, bx, by, bz, C) + neighbour map -> (Bm, bx+2p, by+2p, bz+2p, C).

    Each of the 27 directions gathers its boundary slab of the neighbour
    brick (sliced before the gather, so only the halo surplus moves);
    misses (row Bm) read the zero row. ``pad`` may not exceed any brick
    extent (the 27-neighbour map carries adjacent bricks only).
    """
    bm, bx, by, bz, c = feats.shape
    if not 1 <= pad <= min(bx, by, bz):
        raise ValueError(f"halo pad {pad} outside [1, {min(bx, by, bz)}]")
    fz = torch.cat([feats, feats.new_zeros((1, bx, by, bz, c))])
    nbr = nbr.long()

    def slab(block, d, axis):
        ext = block.shape[axis]
        if d == -1:
            return block.narrow(axis, ext - pad, pad)
        if d == 0:
            return block
        return block.narrow(axis, 0, pad)

    x_parts = []
    for ix, dx in enumerate((-1, 0, 1)):
        y_parts = []
        for iy, dy in enumerate((-1, 0, 1)):
            z_parts = []
            for iz, dz in enumerate((-1, 0, 1)):
                k = (ix * 3 + iy) * 3 + iz
                if dx == dy == dz == 0:
                    z_parts.append(feats)
                    continue
                src = slab(slab(slab(fz, dx, 1), dy, 2), dz, 3)
                z_parts.append(src[nbr[:, k]])
            y_parts.append(torch.cat(z_parts, dim=3))
        x_parts.append(torch.cat(y_parts, dim=2))
    return torch.cat(x_parts, dim=1)


def brick_conv(feats: torch.Tensor, level: BrickLevel, weights: torch.Tensor,
               ksize: int = 3) -> torch.Tensor:
    """Submanifold sparse conv on one (folded) level, plain torch ops.

    feats (Bm, bx, by, bz, Cin); weights (ksize^3, Cin, Cout) in
    lexicographic offset order. The taps run as one matmul over the
    unfolded halo, in float32 whatever the input dtype (the kernel's f32
    accumulation), cast back and masked to occupancy. With ksize=3 this is
    the plain version of K1 (``kernels/brick_conv3.py``); ksize=5 is the
    student's stem.
    """
    pad = ksize // 2
    bm, bx, by, bz, cin = feats.shape
    cout = weights.shape[-1]
    halo = halo_exchange(feats, level.nbr, pad=pad).float()
    patches = (halo.unfold(1, ksize, 1).unfold(2, ksize, 1)
               .unfold(3, ksize, 1))  # (Bm, bx, by, bz, Cin, k, k, k)
    patches = patches.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(
        bm * bx * by * bz, ksize ** 3 * cin)
    out = patches @ weights.float().reshape(ksize ** 3 * cin, cout)
    out = out.reshape(bm, bx, by, bz, cout) * level.occ[..., None]
    return out.to(feats.dtype)


def brick_down_conv(fine_feats: torch.Tensor, group_map: torch.Tensor,
                    coarse: BrickLevel, weights: torch.Tensor,
                    parent_map: torch.Tensor,
                    octant: torch.Tensor) -> torch.Tensor:
    """k2s2 down conv, fine level -> coarse level.

    fine_feats (Bmf, bx,by,bz, Cin); group_map (Bmc, 8); weights (8, Cin,
    Cout) in (0,1)^3 lexicographic order; ``parent_map`` (Bmf,) and
    ``octant`` (Bmf, 3), the group map's inverse, give the gather its
    backward (``_GroupGather``).
    """
    _, bx, by, bz, cin = fine_feats.shape
    cout = weights.shape[-1]
    bmc = group_map.shape[0]
    # (Bmc, 8, bx,by,bz, Cin)
    grp = _GroupGather.apply(fine_feats, group_map, parent_map, octant)
    grp = grp.reshape(bmc, 2, 2, 2, bx, by, bz, cin).permute(
        0, 1, 4, 2, 5, 3, 6, 7)  # (Bmc, 2, bx, 2, by, 2, bz, Cin)
    # stride-2 k2 conv: coarse voxel (X,Y,Z) reads fine (2X+i, 2Y+j, 2Z+k)
    grp = grp.reshape(bmc, bx, 2, by, 2, bz, 2, cin).permute(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(bmc * bx * by * bz, 8 * cin)
    out = grp @ weights.to(grp.dtype).reshape(8 * cin, cout)
    out = out.reshape(bmc, bx, by, bz, cout)
    return out * coarse.occ[..., None].to(out.dtype)


def brick_up_conv(coarse_feats: torch.Tensor, parent_map: torch.Tensor,
                  octant: torch.Tensor, fine: BrickLevel,
                  weights: torch.Tensor,
                  group_map: torch.Tensor) -> torch.Tensor:
    """Transposed k2s2, coarse level -> the encoder's fine level: fine
    voxel p takes W[p & 1] . coarse[p >> 1].

    coarse_feats (Bmc, bx,by,bz, Cin); parent_map (Bmf,); octant (Bmf, 3);
    weights (8, Cin, Cout); ``group_map`` (Bmc, 8), the parent map's
    inverse, gives the gather its backward where autograd records it
    (``_OctantGather``).
    """
    bmc, bx, by, bz, cin = coarse_feats.shape
    cout = weights.shape[-1]
    if _wants_grad(coarse_feats):
        sub = _OctantGather.apply(coarse_feats, parent_map, octant,
                                  group_map)
    else:
        cz = torch.cat([coarse_feats,
                        coarse_feats.new_zeros((1, bx, by, bz, cin))])
        par = cz[torch.clamp(parent_map.long(), max=bmc)]  # (Bmf, bx,by,bz, C)

        # the fine brick's parents are the coarse voxels at [o*e/2,
        # (o+1)*e/2) per axis; select on the small Cin tensor before
        # upsampling
        def pick(t, bit, axis):
            half = t.shape[axis] // 2
            lo, hi = t.narrow(axis, 0, half), t.narrow(axis, half, half)
            return torch.where(bit.reshape((-1,) + (1,) * (t.dim() - 1)),
                               hi, lo)

        sub = pick(par, octant[:, 0].bool(), 1)
        sub = pick(sub, octant[:, 1].bool(), 2)
        sub = pick(sub, octant[:, 2].bool(), 3)  # (Bmf, bx/2, by/2, bz/2, C)

    up = torch.einsum("bxyzc,kcd->bxyzkd", sub, weights.to(sub.dtype))
    up = up.reshape(-1, bx // 2, by // 2, bz // 2, 2, 2, 2, cout)
    up = up.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(-1, bx, by, bz, cout)
    return up * fine.occ[..., None].to(up.dtype)


# ------------------------------------------------- gathers with a backward
#
# Each gather below reads a missing row as zeros. Autograd's backward of
# the plain indexing (``index_put_`` with accumulate) sorts the indices
# and sums each run of equal ones in one warp, so every miss of the
# folded batch joins one serial run on the zero row, whose gradient is
# thrown away. These backwards read each source row's gradient through
# the topology's inverse map instead (a gather: no sort, nothing summed
# on a shared row), from device tensors with no host read, so a CUDA
# graph can capture them. The down conv's forward is the plain indexing
# itself; the up conv's and the points' are taken only where autograd
# records the gather (``_wants_grad``), the plain indexing otherwise.

def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _rows_mask(hit: torch.Tensor, dim: int) -> torch.Tensor:
    """(n,) bool -> (n, 1, ...) of ``dim`` dims: where a gathered row
    is a miss, to be filled with zeros."""
    return (~hit).reshape((-1,) + (1,) * (dim - 1))


class _GroupGather(torch.autograd.Function):
    """``brick_down_conv``'s gather: each coarse brick's 8 fine children,
    (Bmc, 8, bx, by, bz, C), a miss of ``group_map`` reading zeros.

    Backward: fine brick f takes the gradient at slot (parent_map[f],
    oct(f)), oct in ``_offsets(2)`` order; a parent at or past the guard
    (a padded fine brick, or one whose parent the coarse capacity cut)
    reads zeros. ``parent_map`` and ``octant`` are the group map's
    inverse on real bricks, so each fine brick fills at most one slot."""

    @staticmethod
    def forward(ctx, fine, group_map, parent_map, octant):
        ctx.save_for_backward(parent_map, octant)
        pad = fine.new_zeros((1,) + tuple(fine.shape[1:]))
        return torch.cat([fine, pad])[group_map.long()]

    @staticmethod
    def backward(ctx, grad):
        parent_map, octant = ctx.saved_tensors
        with span("bricks.gather_backward"):
            bmc = grad.shape[0]
            parent = parent_map.long()
            o = octant.long()
            slot = (o[:, 0] * 4 + o[:, 1] * 2) + o[:, 2]
            out = grad[parent.clamp(max=bmc - 1), slot]
            out.masked_fill_(_rows_mask(parent < bmc, out.dim()), 0)
        return out, None, None, None


class _OctantGather(torch.autograd.Function):
    """``brick_up_conv``'s gather: each fine brick's octant sub-block of
    its parent, (Bmf, bx/2, by/2, bz/2, C), a parent miss reading zeros.

    Backward: coarse brick c's sub-block k takes the gradient of its
    child ``group_map[c, k]``, zeros where the child is a miss. Every
    coarse voxel lies in one sub-block, which one child at most reads, so
    it is a gather of the output's bytes."""

    @staticmethod
    def forward(ctx, coarse, parent_map, octant, group_map):
        ctx.save_for_backward(group_map)
        bmc, bx, by, bz, _ = coarse.shape
        parent = parent_map.long()
        o = octant.long()
        dev = coarse.device

        def along(axis, ext):
            # the sub-block's coordinates on one axis, (Bmf, ..ext..)
            shape = [-1, 1, 1, 1]
            shape[axis + 1] = ext
            r = torch.arange(ext, device=dev)
            return (o[:, axis, None] * ext + r).reshape(shape)

        sub = coarse[parent.clamp(max=bmc - 1).reshape(-1, 1, 1, 1),
                     along(0, bx // 2), along(1, by // 2), along(2, bz // 2)]
        sub.masked_fill_(_rows_mask(parent < bmc, sub.dim()), 0)
        return sub

    @staticmethod
    def backward(ctx, grad):
        (group_map,) = ctx.saved_tensors
        with span("bricks.gather_backward"):
            bmf, hx, hy, hz, c = grad.shape
            bmc = group_map.shape[0]
            child = group_map.long().reshape(bmc, 2, 1, 2, 1, 2, 1)
            dev = grad.device
            x = torch.arange(hx, device=dev).reshape(1, 1, hx, 1, 1, 1, 1)
            y = torch.arange(hy, device=dev).reshape(1, 1, 1, 1, hy, 1, 1)
            z = torch.arange(hz, device=dev).reshape(1, 1, 1, 1, 1, 1, hz)
            # (Bmc, 2, hx, 2, hy, 2, hz, C): sub-block k = (ox, oy, oz)
            # of the coarse brick is child k's gradient
            out = grad[child.clamp(max=bmf - 1), x, y, z]
            out.masked_fill_((child >= bmf)[..., None], 0)
        return out.reshape(bmc, 2 * hx, 2 * hy, 2 * hz, c), None, None, None


class _PointGather(torch.autograd.Function):
    """``gather_points``' gather: (Bm, bx, by, bz, C) -> (M, C) at each
    point's voxel slot, a point whose row is a miss (a padded point)
    reading zeros.

    Backward: each point's gradient added onto its slot (``index_add_``,
    no sort), exact where two points share a slot. A padded point adds
    onto a spare row of its own past the slots, dropped after, so no
    row sums a run of them."""

    @staticmethod
    def forward(ctx, dense, row, within):
        ctx.save_for_backward(row, within)
        ctx.shape = dense.shape
        bm, bx, by, bz, c = dense.shape
        bv = bx * by * bz
        hit = row < bm
        out = dense.reshape(bm * bv, c)[
            torch.where(hit, row * bv + within, 0)]
        out.masked_fill_(_rows_mask(hit, 2), 0)
        return out

    @staticmethod
    def backward(ctx, grad):
        row, within = ctx.saved_tensors
        with span("bricks.gather_backward"):
            bm, bx, by, bz, c = ctx.shape
            bv = bx * by * bz
            n, m = bm * bv, grad.shape[0]
            spare = n + torch.arange(m, device=grad.device)
            dst = torch.where(row < bm, row * bv + within, spare)
            out = grad.new_zeros((n + m, c)).index_add_(0, dst, grad)
        return out[:n].reshape(ctx.shape), None, None
