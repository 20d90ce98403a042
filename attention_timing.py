#!/usr/bin/env python3
"""Per-call times of the attention kernel (K3, K4, K5) on one CUDA card.

    python3 attention_timing.py [--tree DIR] [--reps N]
                                [--rows {all,bf16,f32,d80}]
                                [--define NAME=VALUE ...]

Times the entry points of ``ops/attention.py`` from the checkout at
``--tree`` (default: this one), so that two versions of the kernel can be
compared on one card in one call, in turns (parent, change, change,
parent). The kernel is built from that checkout's sources into its own
``build/kernels/``; ``--define`` builds it with preprocessor defines
(``K5F32_PROBE=<bits>``: the float32 kernel with a part taken out, see
``csrc/attention.cu``). The shapes are ``chip_smoke.py``'s rows: bf16
K3 at the ViT-L teacher's (96, 769, 16, 64), K5 at the hi-res patch
extract's (8, 3073, 16, 64), DINO v1 hi-res (1, 3026, 6, 64) and causal
text (32, 77, 12, 64); the D = 80 rows (``--rows d80``) K4 at OpenCLIP
ViT-H/14's ingest shape (96, 337, 16, 80) and K5 at (8, 1025, 16, 80);
float32 K5 at DINO v1 S/8's (1, 3026, 6, 64) and
(1, 16130, 6, 64), each also held to ``chip_smoke.attention_f32_close``
against the plain version (the share of the limit it takes) and read,
with the plain version, against float64. ``F.scaled_dot_product_attention``
is timed beside them as the library yardstick; the bound is
``chip_smoke.tc_bound``'s (float32 at 3xTF32). Each time is the mean of
``--reps`` back-to-back calls between CUDA events, after two warm-up calls
(``chip_smoke.cuda_ms``). Prints the card line (``nvidia-smi`` name and
power limit) and, last, one JSON object.
"""

import argparse
import json
import os
import sys

import torch

from chip_smoke import (attention_f32_close, attention_f64, card_line,
                        cuda_ms, tc_bound)

CASES = (("K3", 96, 769, 16, 64, False, torch.bfloat16),
         ("K5", 8, 3073, 16, 64, False, torch.bfloat16),
         ("K5 DINO", 1, 3026, 6, 64, False, torch.bfloat16),
         ("K5 causal", 32, 77, 12, 64, True, torch.bfloat16),
         ("K4 ViT-H", 96, 337, 16, 80, False, torch.bfloat16),
         ("K5 d80", 8, 1025, 16, 80, False, torch.bfloat16),
         ("K5 DINO v1 224 f32", 1, 3026, 6, 64, False, torch.float32),
         ("K5 DINO v1 512 f32", 1, 16130, 6, 64, False, torch.float32))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dropclip_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rows", choices=("all", "bf16", "f32", "d80"),
                    default="all")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE for nvcc's -D (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch.nn.functional as F

    from dropclip_tpu_torch.kernels import attention as kernel
    from dropclip_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.define:
        kernel.LIB = kernel.LIB.variant(*args.define)
    card = card_line()
    rows = {}
    for tag, b, t, h, d, causal, dtype in CASES:
        f32 = dtype == torch.float32
        group = "f32" if f32 else "d80" if d == 80 else "bf16"
        if args.rows != "all" and args.rows != group:
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        if tag == "K3":
            packed = [x.reshape(b, t, h * d) for x in (q, k, v)]
            kern = lambda: att.oneshot_attention_packed(*packed, h)
        elif tag.startswith("K4"):
            kern = lambda: att.oneshot_attention(q, k, v)
        else:
            kern = lambda: att.flash_attention_padded(q, k, v, causal)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=causal)
        flops = 4.0 * b * h * (t * (t + 1) / 2 if causal else t * t) * d
        bound, _ = tc_bound(flops, 4.0 * b * t * h * d * q.element_size(),
                            dtype)
        ms = cuda_ms(kern, args.reps)
        row = dict(shape=[b, t, h, d], dtype=str(dtype), causal=causal,
                   ms=ms, tflops=flops / ms / 1e9, bound_ms=bound,
                   bound_share=bound / ms, sdpa_ms=cuda_ms(sdpa, args.reps))
        if f32:
            got = kern()
            ref = att.flash_attention_plain(q, k, v, causal)
            ok, _, share = attention_f32_close(got, ref)
            ref64 = attention_f64(q, k, v, causal)
            row.update(within=ok, limit_share=share,
                       max_abs_err=float((got - ref).abs().max()),
                       f64_max_abs_err=float((got.double() - ref64)
                                             .abs().max()),
                       plain_f64_max_abs_err=float((ref.double() - ref64)
                                                   .abs().max()))
            del got, ref, ref64
        rows[tag] = row
        print(f"{tag} {(b, t, h, d)}{' causal' if causal else ''}: "
              f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
              f"{row['bound_share']:.3f} of the bound {bound:.4f}), sdpa "
              f"{row['sdpa_ms']:.4f} ms"
              + (f"; {row['limit_share']:.3f} of the limit (within: "
                 f"{row['within']}), vs float64 kernel "
                 f"{row['f64_max_abs_err']:.3e} plain "
                 f"{row['plain_f64_max_abs_err']:.3e}" if f32 else ""),
              flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"tree": tree, "defines": args.define, "card": card,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
