#!/usr/bin/env python3
"""What bounds the brick conv (K1) on one CUDA card: its source built with
parts taken out, timed side by side.

    python3 brick_conv_variants.py [--reps N]

``csrc/brick_conv3.cu`` has a compile-time knob, ``K1_PROBE`` (0 in the
port), whose bits take a part of the kernel out. Each variant is built
apart (``kernels/nvcc.CudaLibrary.variant``), launched with the arguments
the wrapper passes (the level's shared row schedule) at five main-path
shapes of ``chip_smoke.py``'s batch-8 forward, in float32 and bf16:

- ``base``: the source as it is (its error against the plain version is
  printed; the variants below are timings of deliberately broken kernels);
- ``no_mma`` (bit 1): the tensor-core products removed (on mma.sync
  replaced by a cheap use of their fragments, so the fragment loads and
  splits still run);
- ``no_loads`` (bit 2): no cp.async: the ring holds whatever it held;
- ``one_product`` (bit 4, float32 only): hi*hi only (1xTF32);
- ``all_taps``: the base kernel with every tap of every occupied row
  live, i.e. without stage C's skip (masks all ones; the result is still
  right, since a dead tap reads zeros).

Each time is the mean of ``--reps`` back-to-back launches between CUDA
events after two warm-up launches (``chip_smoke.cuda_ms``). Prints the
card line (``nvidia-smi`` name and power limit) and, last, one JSON
object.
"""

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from chip_smoke import (BATCH, ROOT, SEED, brick_pipeline, card_line, check,
                        cuda_ms, k1_cases, k1_inputs, make_clouds)

SHAPES = (14, 12, 10, 7, 0)  # main_path_shapes indices: L0 416->384 ...
PROBES = {"base": 0, "no_mma": 1, "no_loads": 2, "one_product": 4}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("brick_conv_variants: no CUDA device visible", file=sys.stderr)
        return 2
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.kernels import brick_conv3 as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    variants = {name: k1.LIB.variant(f"K1_PROBE={bits}")
                for name, bits in PROBES.items()}
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda v: v.build(), variants.values()))
    libs = {name: v.load() for name, v in variants.items()}

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    clouds, rgbs = make_clouds(BATCH)
    pipe = brick_pipeline(cfg, clouds, rgbs, None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for i, lvl, c, cout, lv, _, sched in k1_cases(pipe, clouds, rgbs):
        if i not in SHAPES:
            continue
        order, n_occ, masks = sched
        full = torch.full_like(masks, (1 << 27) - 1)
        bm, bx, by, bz = lv.occ.shape
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, w = k1_inputs(lv, c, cout, dtype, gen)
            ref = k1.brick_conv3_plain(x, lv.nbr, w, lv.occ).float()
            out = torch.empty((bm, bx, by, bz, cout), dtype=dtype,
                              device="cuda")
            kind = k1.KINDS[k1.instance(dtype, c, cout)]
            stream = torch.cuda.current_stream().cuda_stream

            def launch(lib, m):
                return lambda: lib.dropclip_brick_conv3(
                    x.data_ptr(), lv.nbr.data_ptr(), w.data_ptr(),
                    order.data_ptr(), n_occ.data_ptr(), m.data_ptr(),
                    out.data_ptr(), bm, bx, by, bz, c, cout, kind, stream)

            row = dict(shape=i, level=lvl, c=c, cout=cout, dtype=tag)
            runs = [(n, launch(lib, masks)) for n, lib in libs.items()
                    if not (n == "one_product" and tag == "bf16")]
            runs.append(("all_taps", launch(libs["base"], full)))
            for name, fn in runs:
                check(fn() == 0, f"{name} did not launch")
                torch.cuda.synchronize()
                if name in ("base", "all_taps"):
                    err = float((out.float() - ref).abs().max()
                                / ref.abs().max())
                    check(err < (1e-4 if tag == "f32" else 1e-2),
                          f"{name} disagrees with the plain version: {err}")
                    row[f"{name}_rel_err"] = err
                row[name] = cuda_ms(fn, args.reps)
            rows.append(row)
            print(f"L{lvl} {c}->{cout} {tag}: " + ", ".join(
                f"{n} {row[n]:.4f}" for n, _ in runs) + " ms", flush=True)
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
