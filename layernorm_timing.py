#!/usr/bin/env python3
"""Per-call times of the LayerNorm kernels (K6, K7) on one CUDA card.

    python3 layernorm_timing.py [--tree DIR] [--config ROWS,WARPS ...]

Times ``ops/layernorm.py``'s K6 and K7 from the checkout at ``--tree``
(default: this one), so that two versions can be compared on one card in
one call, in turns (parent, change, change, parent), at the rows the
port's paths give them: K6 float32 (3026, 384) and (16130, 384) (DINO v1
S/8 at 224x224 and 512x512, eps 1e-6), bf16 (308, 768) (the text tower's
4 x 77 prompts), bf16 (73824, 1024) (the ViT-L teacher's 96 crops of
769), bf16 and float32 (24584, 1024) (DINOv2-L on 8 frames at 672x896);
K7 bf16 (73824, 1024) and (24584, 1024); and K6 bf16 at the one-warp
instance: (308, 512) (RN50's text tower) and (16130, 384), where it also
counts its values beyond one unfloored bf16 ulp of the plain result and
of the float64 LayerNorm, beside the plain version's count against the
float64 one (``ulp_misses``). Each row is held to
``chip_smoke.ln_close`` against its plain version and timed three ways,
beside ``F.layer_norm`` (for K7: an add, then ``F.layer_norm``): back to
back between CUDA events (``chip_smoke.cuda_ms``, 20 calls, the larger of
the host and the device time per call), and split into the device time
per call (``chip_smoke.device_ms``, the profiler's median of 51 calls)
and the host time per call (``chip_smoke.host_ms``, the median of 101
calls of each, kernel and library in turns). ``--config`` times the
rows of 512 lanes or fewer again with K6's launch configuration for them
replaced at every row count (ROWS rows a program, WARPS warps; this
checkout's ``launch_config`` only). Prints the card line (``nvidia-smi`` name and
power limit) and, last, one JSON object.
"""

import argparse
import json
import os
import sys

import torch

from chip_smoke import PEAK_BYTES, card_line, check, cuda_ms, device_ms, \
    host_ms, ln_close

CASES = (("K6", 3026, 384, torch.float32, 1e-6),
         ("K6", 16130, 384, torch.float32, 1e-6),
         ("K6", 4 * 77, 768, torch.bfloat16, 1e-5),
         ("K6", 4 * 77, 512, torch.bfloat16, 1e-5),
         ("K6", 16130, 384, torch.bfloat16, 1e-6),
         ("K6", 96 * 769, 1024, torch.bfloat16, 1e-5),
         ("K6", 8 * 3073, 1024, torch.bfloat16, 1e-6),
         ("K6", 8 * 3073, 1024, torch.float32, 1e-6),
         ("K7", 96 * 769, 1024, torch.bfloat16, 1e-5),
         ("K7", 8 * 3073, 1024, torch.bfloat16, 1e-6))


def ulp_misses(x, s, b, eps, got, ref):
    """Where bf16 K6 leaves one unfloored bf16 ulp of the plain result,
    and whether the plain version (float32 statistics in torch's order)
    does the same against the float64-computed LayerNorm rounded to bf16:
    if both miss at about the same rate, the misses come from float32
    reduction order, not from the kernel's configuration."""
    def count(a, r):
        a, r = a.float(), r.float()
        ulp = 2.0 ** (torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
        return int(((a - r).abs() > ulp).sum())

    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    var = (xd - mean).square().mean(-1, keepdim=True)
    exact = ((xd - mean) * torch.rsqrt(var + eps) * s.double() + b.double()
             ).to(x.dtype)
    return dict(misses_vs_plain=count(got, ref),
                misses_vs_f64=count(got, exact),
                plain_misses_vs_f64=count(ref, exact))


def time_row(ln, F, kind, n, c, dtype, eps):
    gen = torch.Generator(device="cuda").manual_seed(n + c)
    x = (torch.randn((n, c), generator=gen, device="cuda") * 3).to(dtype)
    s = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    sd, bd = s.to(dtype), b.to(dtype)
    if kind == "K7":
        d = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
        kern = lambda: ln.add_layer_norm(x, d, s, b, eps=eps)
        got, ref = kern()[1], ln.add_layer_norm_plain(x, d, s, b, eps)[1]

        def library():
            y = x + d
            return y, F.layer_norm(y, (c,), sd, bd, eps)

        nbytes = 4.0 * n * c * x.element_size()
    else:
        kern = lambda: ln.layer_norm(x, s, b, eps=eps)
        got, ref = kern(), ln.layer_norm_plain(x, s, b, eps)
        library = lambda: F.layer_norm(x, (c,), sd, bd, eps)
        nbytes = 2.0 * n * c * x.element_size()
    torch.cuda.synchronize()
    check(ln_close(got, ref, dtype), f"{kind} ({n}, {c}) {dtype}: max err "
          f"{float((got.float() - ref.float()).abs().max())}")
    row = dict(kind=kind, rows=n, c=c, dtype=str(dtype), eps=eps,
               bound_ms=(nbytes + 2 * c * 4) / PEAK_BYTES * 1e3,
               ms=cuda_ms(kern, 20), library_ms=cuda_ms(library, 20))
    if kind == "K6" and dtype == torch.bfloat16:
        row.update(ulp_misses(x, s, b, eps, got, ref))
    row["device_ms"] = device_ms(kern)
    row["library_device_ms"] = device_ms(library, 1 + (kind == "K7"))
    row["host_ms"], row["library_host_ms"] = host_ms((kern, library))
    print(f"{kind} ({n}, {c}) {dtype}: kernel {row['ms']:.5f} ms (device "
          f"{row['device_ms']:.5f}, host {row['host_ms']:.5f}), library "
          f"{row['library_ms']:.5f} ms (device "
          f"{row['library_device_ms']:.5f}, host "
          f"{row['library_host_ms']:.5f}), bound {row['bound_ms']:.5f} ms",
          flush=True)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dropclip_tpu_torch is timed")
    ap.add_argument("--config", action="append", default=[],
                    help="ROWS,WARPS for rows of 512 lanes or fewer")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("layernorm_timing: no CUDA device visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops import layernorm as ln

    card = card_line()
    rows = [time_row(ln, F, *case) for case in CASES]
    for cfg in args.config:
        per, warps = (int(v) for v in cfg.split(","))
        base = ln.launch_config

        def config(n_rows, c):
            block, r, w = base(n_rows, c)
            return (block, per, warps) if block <= ln.WARP_ROW_MAX else \
                (block, r, w)

        ln.launch_config = config
        try:
            for case in CASES:
                if case[2] <= ln.WARP_ROW_MAX:
                    rows.append(dict(time_row(ln, F, *case), config=cfg))
        finally:
            ln.launch_config = base
    print(card)
    print(json.dumps({"tree": tree, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
