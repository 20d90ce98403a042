"""Convert reference (torch + MinkowskiEngine) student checkpoints.

Port of ``dropclip_tpu/sparse/convert_student.py``. The reference
distributes trained DisNet/MinkUNet weights as torch ``.pth`` state
dicts (reference README.md:29, tools/train_distil.py:255-271; eval loads
them stripping the DDP "module." prefix, models/distil/disnet.py:7-12).
``from_minkowski_state_dict`` maps one onto the JAX package's layout,
nested dicts of numpy arrays (``params``, ``batch_stats``), key for key
as the JAX converter does, and ``minkowski_student_state_dict`` takes
that tree through ``convert.student_state_dict`` onto the port's
student: one mapping, held against the JAX converter, serving both
engines (bricks and gather register the same keys).

Key mapping (reference models/distil/minkunet.py:46-126 +
resnet_base.py:31-137):

- ``conv0p1s1`` (k5 stem), ``conv{1..4}p*s2`` (k2s2 down),
  ``convtr{4..7}p*s2`` (k2s2 up), ``final`` / ``cls_head`` (1x1) ->
  same-purpose modules here (``conv1..4`` / ``convtr4..7`` drop the
  stride suffix).
- ``block{b}.{i}.conv1/norm1/conv2/norm2/downsample.{0,1}`` ->
  ``block{b}_{i}.conv1/norm1/conv2/norm2/downsample_conv/
  downsample_norm``.
- ``bn*.bn.{weight,bias}`` -> params ``{scale, bias}``;
  ``running_{mean,var}`` -> batch_stats ``{mean, var}``.

Kernel layout: ME stores (kernel_volume, Cin, Cout) with offsets from
its region generator; the port uses lexicographic offsets with the LAST
axis fastest. ``offset_order`` selects the assumed ME ordering:
"x_fastest" (first axis fastest, ME's hypercube region iterator) or
"z_fastest" (identity). A wrong order loads cleanly and only scrambles
predictions; ``tools/convert_checkpoint --offset-order auto`` scores
both.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..convert import student_state_dict
from .unet import UNET_ARCHS


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _perm(ksize: int, offset_order: str) -> np.ndarray:
    """Permutation taking ME kernel rows -> our z-fastest lexicographic."""
    rng = np.arange(ksize)
    ours = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"),
                    -1).reshape(-1, 3)  # x slowest, z fastest
    if offset_order == "z_fastest":
        me = ours
    elif offset_order == "x_fastest":
        me = ours[:, ::-1]  # ME row k holds offset (z, y, x) of ours
    else:
        raise ValueError(offset_order)
    lut = {tuple(o): i for i, o in enumerate(me)}
    return np.array([lut[tuple(o)] for o in ours])


def _conv(sd: Mapping, key: str, ksize: int, order: str) -> Dict[str, Any]:
    w = _np(sd[f"{key}.kernel"])
    if w.ndim == 2:  # 1x1: ME stores (Cin, Cout)
        w = w[None]
    elif ksize > 1:
        w = w[_perm(ksize, order)]
    return {"kernel": w}


def _bn(sd: Mapping, key: str) -> Tuple[Dict, Dict]:
    return ({"scale": _np(sd[f"{key}.bn.weight"]),
             "bias": _np(sd[f"{key}.bn.bias"])},
            {"mean": _np(sd[f"{key}.bn.running_mean"]),
             "var": _np(sd[f"{key}.bn.running_var"])})


def from_minkowski_state_dict(sd: Mapping[str, Any],
                              arch: str = "MinkUNet14D",
                              offset_order: str = "x_fastest"
                              ) -> Tuple[Dict, Dict]:
    """torch MinkUNet state dict -> (params, batch_stats) pytrees."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    # DisNet wraps the UNet as `net3d` (reference disnet.py:24-39)
    if any(k.startswith("net3d.") for k in sd):
        sd = {k[len("net3d."):]: v for k, v in sd.items()
              if k.startswith("net3d.")}
    block, layers, _ = UNET_ARCHS[arch]

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put_bn(our: str, ref: str) -> None:
        p, s = _bn(sd, ref)
        params[our] = {**params.get(our, {}), **p} if our in params else p
        stats[our] = s

    params["conv0p1s1"] = _conv(sd, "conv0p1s1", 5, offset_order)
    put_bn("bn0", "bn0")
    for s_i in range(1, 5):
        stride = [1, 2, 4, 8][s_i - 1]
        params[f"conv{s_i}"] = _conv(sd, f"conv{s_i}p{stride}s2", 2,
                                     offset_order)
        put_bn(f"bn{s_i}", f"bn{s_i}")
    for d in range(4):
        stride = 16 >> d
        params[f"convtr{4 + d}"] = _conv(
            sd, f"convtr{4 + d}p{stride}s2", 2, offset_order)
        put_bn(f"bntr{4 + d}", f"bntr{4 + d}")

    convs_per_block = {"basic": ("conv1", "conv2"),
                       "bottleneck": ("conv1", "conv2", "conv3")}[block]
    for b in range(1, 9):
        for i in range(layers[b - 1]):
            ref = f"block{b}.{i}"
            our = f"block{b}_{i}"
            sub_p: Dict[str, Any] = {}
            sub_s: Dict[str, Any] = {}
            for ci, cname in enumerate(convs_per_block, start=1):
                k = 3 if cname == "conv2" or block == "basic" else 1
                sub_p[cname] = _conv(sd, f"{ref}.{cname}", k, offset_order)
                bnp, bns = _bn(sd, f"{ref}.norm{ci}")
                sub_p[f"norm{ci}"] = bnp
                sub_s[f"norm{ci}"] = bns
            if f"{ref}.downsample.0.kernel" in sd:
                sub_p["downsample_conv"] = _conv(
                    sd, f"{ref}.downsample.0", 1, offset_order)
                bnp, bns = _bn(sd, f"{ref}.downsample.1")
                sub_p["downsample_norm"] = bnp
                sub_s["downsample_norm"] = bns
            params[our] = sub_p
            stats[our] = sub_s

    params["final"] = _conv(sd, "final", 1, offset_order)
    if "cls_head.kernel" in sd:
        params["cls_head"] = _conv(sd, "cls_head", 1, offset_order)
    return params, stats


def _inv_conv(w, ksize: int, offset_order: str) -> np.ndarray:
    """Inverse of _conv: our (K^3, Cin, Cout) kernel -> ME row layout."""
    w = np.asarray(w, np.float32)
    if ksize == 1:
        return w[0]  # ME stores 1x1 as (Cin, Cout)
    p = _perm(ksize, offset_order)
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return w[inv]


def to_minkowski_state_dict(params: Mapping, stats: Mapping,
                            arch: str = "MinkUNet14D",
                            offset_order: str = "x_fastest",
                            wrap: bool = True) -> Dict[str, Any]:
    """Inverse of from_minkowski_state_dict: our (params, batch_stats)
    pytrees -> a reference-layout torch-style state dict (numpy values).

    The migration path OUT of this framework (and the fixture generator
    for offset-order detection tests): round-trips bit-exactly through
    from_minkowski_state_dict for every arch/order
    (tests/test_convert_student.py). ``wrap`` adds the DDP + DisNet
    ``module.net3d.`` prefix real reference checkpoints carry
    (reference disnet.py:24-39, train_distil.py:255-271)."""
    block, layers, _ = UNET_ARCHS[arch]
    sd: Dict[str, Any] = {}

    def put_bn(ref: str, p: Mapping, s: Mapping) -> None:
        sd[f"{ref}.bn.weight"] = np.asarray(p["scale"], np.float32)
        sd[f"{ref}.bn.bias"] = np.asarray(p["bias"], np.float32)
        sd[f"{ref}.bn.running_mean"] = np.asarray(s["mean"], np.float32)
        sd[f"{ref}.bn.running_var"] = np.asarray(s["var"], np.float32)

    sd["conv0p1s1.kernel"] = _inv_conv(params["conv0p1s1"]["kernel"], 5,
                                       offset_order)
    put_bn("bn0", params["bn0"], stats["bn0"])
    for s_i in range(1, 5):
        stride = [1, 2, 4, 8][s_i - 1]
        sd[f"conv{s_i}p{stride}s2.kernel"] = _inv_conv(
            params[f"conv{s_i}"]["kernel"], 2, offset_order)
        put_bn(f"bn{s_i}", params[f"bn{s_i}"], stats[f"bn{s_i}"])
    for d in range(4):
        stride = 16 >> d
        sd[f"convtr{4 + d}p{stride}s2.kernel"] = _inv_conv(
            params[f"convtr{4 + d}"]["kernel"], 2, offset_order)
        put_bn(f"bntr{4 + d}", params[f"bntr{4 + d}"],
               stats[f"bntr{4 + d}"])

    convs_per_block = {"basic": ("conv1", "conv2"),
                       "bottleneck": ("conv1", "conv2", "conv3")}[block]
    for b in range(1, 9):
        for i in range(layers[b - 1]):
            ref = f"block{b}.{i}"
            our_p, our_s = params[f"block{b}_{i}"], stats[f"block{b}_{i}"]
            for ci, cname in enumerate(convs_per_block, start=1):
                k = 3 if cname == "conv2" or block == "basic" else 1
                sd[f"{ref}.{cname}.kernel"] = _inv_conv(
                    our_p[cname]["kernel"], k, offset_order)
                put_bn(f"{ref}.norm{ci}", our_p[f"norm{ci}"],
                       our_s[f"norm{ci}"])
            if "downsample_conv" in our_p:
                sd[f"{ref}.downsample.0.kernel"] = _inv_conv(
                    our_p["downsample_conv"]["kernel"], 1, offset_order)
                put_bn(f"{ref}.downsample.1", our_p["downsample_norm"],
                       our_s["downsample_norm"])

    sd["final.kernel"] = _inv_conv(params["final"]["kernel"], 1,
                                   offset_order)
    if "cls_head" in params:
        sd["cls_head.kernel"] = _inv_conv(params["cls_head"]["kernel"], 1,
                                          offset_order)
    if wrap:
        sd = {f"module.net3d.{k}": v for k, v in sd.items()}
    return sd


def minkowski_student_state_dict(sd: Mapping[str, Any],
                                 arch: str = "MinkUNet14D",
                                 offset_order: str = "x_fastest"
                                 ) -> Dict[str, Any]:
    """A MinkowskiEngine state dict -> the port student's state dict
    (``MinkUNetBricks`` and ``MinkUNet`` alike), through the JAX-layout
    trees of ``from_minkowski_state_dict``."""
    return student_state_dict(*from_minkowski_state_dict(
        sd, arch=arch, offset_order=offset_order))
