#!/usr/bin/env python3
"""Per-call times of the attention kernel (K3, K4, K5) on one CUDA card.

    python3 attention_timing.py [--tree DIR] [--reps N]

Times the entry points of ``ops/attention.py`` from the checkout at
``--tree`` (default: this one), so that two versions of the kernel can be
compared on one card in one call, in turns (parent, change, change,
parent). The kernel is built from that checkout's sources into its own
``build/kernels/``. The shapes are ``chip_smoke.py``'s bf16 rows: K3 at the
ViT-L teacher's (96, 769, 16, 64), K5 at the hi-res patch extract's (8,
3073, 16, 64), DINO v1 hi-res (1, 3026, 6, 64) and causal text (32, 77,
12, 64); ``F.scaled_dot_product_attention`` is timed beside them as the
library yardstick. Each time is the mean of ``--reps`` back-to-back calls
between CUDA events, after two warm-up calls (``chip_smoke.cuda_ms``).
Prints the card line (``nvidia-smi`` name and power limit) and, last, one
JSON object.
"""

import argparse
import json
import os
import sys

import torch

from chip_smoke import card_line, cuda_ms

CASES = (("K3", 96, 769, 16, False), ("K5", 8, 3073, 16, False),
         ("K5 DINO", 1, 3026, 6, False), ("K5 causal", 32, 77, 12, True))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose dropclip_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops import attention as att

    card = card_line()
    rows = {}
    for tag, b, t, h, causal in CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((b, t, h, 64), generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        if tag == "K3":
            packed = [x.reshape(b, t, h * 64) for x in (q, k, v)]
            kern = lambda: att.oneshot_attention_packed(*packed, h)
        else:
            kern = lambda: att.flash_attention_padded(q, k, v, causal)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       is_causal=causal)
        flops = 4.0 * b * h * (t * (t + 1) / 2 if causal else t * t) * 64
        ms = cuda_ms(kern, args.reps)
        rows[tag] = dict(shape=[b, t, h, 64], causal=causal, ms=ms,
                         tflops=flops / ms / 1e9,
                         sdpa_ms=cuda_ms(sdpa, args.reps))
        print(f"{tag} {(b, t, h, 64)}{' causal' if causal else ''}: "
              f"{ms:.4f} ms ({rows[tag]['tflops']:.1f} TFLOP/s), sdpa "
              f"{rows[tag]['sdpa_ms']:.4f} ms", flush=True)
    print(card)
    print(json.dumps({"tree": tree, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
