"""Point-cloud cleanup: RANSAC plane removal, outlier filters, voxel
pooling.

Port of ``dropclip_tpu/geom/cleanup.py``: replacements for the Open3D
(C++) cleanup routines the reference calls during raw-scene handling
(reference utils/geometry.py):

- ``plane_removal`` (:48-59): ``segment_plane`` RANSAC, then drop the
  plane inliers. Every candidate triple is drawn at once (``torch.
  multinomial`` from an explicit ``torch.Generator``, with the
  probabilities of the JAX package's ``jax.random.choice``: the same
  distribution, other draws), the point-plane distances are one (K, N)
  product, and the model with most inliers wins.
- ``remove_stat_outlier`` (:355-359): keep points whose mean k-NN
  distance is under ``mean + ratio * std`` of the cloud's.
- ``pc_outlier_removal`` (:362-380): voxel-downsample, then radius
  outlier removal (keep points with >= ``min_points`` neighbours inside
  ``eps``); returns kept indices *into the downsampled cloud*, the
  reference's contract.
- ``voxel_pool``: the host voxelizer of REGRAD ingest (numpy).

Neighbour searches are chunked pairwise distances in torch ops on the
device given (the card unless the caller asks for the CPU): the clouds
are a few 10k points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def segment_plane(points: torch.Tensor, mask: torch.Tensor,
                  distance_threshold: float = 0.01, ransac_n: int = 3,
                  num_iterations: int = 1000,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC plane fit on the device of ``points``. points (N, 3), mask
    (N,) valid -> ((a, b, c, d) with |n| = 1, inlier mask (N,) incl.
    validity). ``generator`` (on that device) draws the triples."""
    del ransac_n  # planes are fit from triples; kept for API parity
    probs = mask.to(torch.float32)
    probs = probs / probs.sum().clamp_min(1.0)
    idx = torch.multinomial(probs, num_iterations * 3, replacement=True,
                            generator=generator).reshape(num_iterations, 3)
    tri = points[idx]  # (K, 3, 3)
    normal = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = normal.norm(dim=-1, keepdim=True)
    normal = normal / norm.clamp_min(1e-12)
    d = -(normal * tri[:, 0]).sum(-1)  # (K,)
    dist = (points @ normal.T + d[None, :]).abs().T  # (K, N)
    # a degenerate triple has a zero normal and never wins the vote
    inlier = (dist <= distance_threshold) & mask[None, :] & (norm > 1e-9)
    best = torch.argmax(inlier.sum(1))
    return torch.cat([normal[best], d[best][None]]), inlier[best]


def plane_removal(points: np.ndarray, distance_threshold: float = 0.01,
                  ransac_n: int = 3, num_iterations: int = 1000,
                  device=None, seed: int = 0) -> np.ndarray:
    """Drop the dominant plane's inliers (reference geometry.py:48-59)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    _, inlier = segment_plane(pts, torch.ones(len(pts), dtype=torch.bool,
                                              device=dev),
                              distance_threshold, ransac_n, num_iterations,
                              generator=gen)
    return np.asarray(points)[~inlier.cpu().numpy()]


def _pair_d2(qc: torch.Tensor, points: torch.Tensor,
             sq: torch.Tensor) -> torch.Tensor:
    return (qc * qc).sum(-1)[:, None] - 2.0 * qc @ points.T + sq[None]


def _knn_mean_dist(points: torch.Tensor, mask: torch.Tensor, k: int,
                   chunk: int = 2048) -> torch.Tensor:
    """Mean distance to the k nearest valid neighbours (self excluded)."""
    sq = (points * points).sum(-1)
    out = []
    for qc in points.split(chunk):
        d2 = torch.where(mask[None, :], _pair_d2(qc, points, sq),
                         torch.tensor(1e30, device=points.device))
        near = torch.topk(d2, k + 1, dim=1, largest=False).values
        out.append(near[:, 1:].clamp_min(0.0).sqrt().mean(-1))
    return torch.cat(out)


def remove_stat_outlier(points: np.ndarray, n_pts: int = 25,
                        ratio: float = 2.0, device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Statistical outlier removal (reference geometry.py:355-359):
    keep points whose mean ``n_pts``-NN distance < mean + ratio * std.
    Returns (kept points, kept indices)."""
    if len(points) <= 1:  # no neighbours to judge by: keep everything
        return np.asarray(points), np.arange(len(points))
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    md = _knn_mean_dist(pts, torch.ones(len(pts), dtype=torch.bool,
                                        device=dev),
                        min(n_pts, len(pts) - 1)).cpu().numpy()
    ind = np.nonzero(md < md.mean() + ratio * md.std())[0]
    return np.asarray(points)[ind], ind


def _radius_counts(points: torch.Tensor, mask: torch.Tensor, radius: float,
                   chunk: int = 2048) -> torch.Tensor:
    """Number of valid neighbours (self excluded) within ``radius``."""
    sq = (points * points).sum(-1)
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    return torch.cat([((_pair_d2(qc, points, sq) <= r2) & mask[None, :]
                       ).sum(-1) - 1 for qc in points.split(chunk)])


def voxel_pool(xyz: np.ndarray, payloads=None, labels=None,
               voxel_size: float = 0.0075):
    """Host voxel downsample: mean xyz + mean of each payload + majority
    label (the REGRAD-ingest analogue of the reference's o3d voxel_down +
    KD-tree feature counters, utils/projections.py:151-211).

    Returns (xyz_v, {name: pooled}, labels_v): payloads empty or None give
    {}, labels None gives None."""
    xyz = np.asarray(xyz, np.float32)
    payloads = payloads or {}
    grid = np.floor(xyz / voxel_size).astype(np.int64)
    grid -= grid.min(axis=0)
    dims = grid.max(axis=0) + 1
    key = (grid[:, 0] * dims[1] + grid[:, 1]) * dims[2] + grid[:, 2]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    u = len(counts)
    # rows grouped by voxel in their input order: pass r adds each voxel's
    # r-th row, so every voxel sums its rows in input order in float64, as
    # the JAX package's np.add.at does (the same bits), without its
    # element-wise scatter; np.add.reduceat over the sorted rows gives the
    # same bits in twice the time at REGRAD's 180k rows of 768
    order = np.argsort(inv, kind="stable")
    starts = np.cumsum(counts) - counts
    passes = []
    for r in range(int(counts.max()) if u else 0):
        groups = np.flatnonzero(counts > r)
        passes.append((groups, order[starts[groups] + r]))

    def mean_of(arr):
        arr = np.asarray(arr)
        out = np.zeros((u,) + arr.shape[1:], np.float64)
        for groups, rows in passes:
            out[groups] += arr[rows]
        return (out / counts.reshape((-1,) + (1,) * (arr.ndim - 1))
                ).astype(np.float32)

    lab_out = None
    if labels is not None:
        lab_ids, lab_inv = np.unique(np.asarray(labels), return_inverse=True)
        votes = np.bincount(inv * len(lab_ids) + lab_inv,
                            minlength=u * len(lab_ids)).reshape(u, -1)
        lab_out = lab_ids[np.argmax(votes, axis=1)]
    return mean_of(xyz), {k: mean_of(v) for k, v in payloads.items()}, lab_out


def pc_voxel_down(pc: np.ndarray, voxel_size: float = 0.0075) -> np.ndarray:
    """Host voxel-average downsample of a raw cloud (reference
    geometry.py:350-352, o3d ``voxel_down_sample``)."""
    return voxel_pool(pc, voxel_size=voxel_size)[0]


def pc_outlier_removal(pc: np.ndarray, eps: float = 0.05,
                       min_points: int = 15, voxel_size: float = 0.02,
                       device=None) -> np.ndarray:
    """Voxel-downsample then radius outlier removal (reference
    geometry.py:362-380). Returns the kept indices into the DOWNSAMPLED
    cloud, the reference's contract."""
    dev = resolve_device(device)
    down = torch.as_tensor(pc_voxel_down(pc, voxel_size), device=dev)
    counts = _radius_counts(down, torch.ones(len(down), dtype=torch.bool,
                                             device=dev), eps)
    return np.nonzero(counts.cpu().numpy() >= min_points)[0]
