"""The attention kernel's D = 80 instance (``attention_kernel_d80``, K4
at ViT-H/14's heads) in its share of the roofline over the traced
scenes: the least time of its launches' work (``4 * rows * tokens**2 *
width`` a launch at bf16's 989 TFLOP/s, or its q, k, v and output read
or written once at 3.35 TB/s, whichever is longer: the bytes, at (96,
337, 16 x 80); 96 crops a launch, as the program chunks them, and as
many launches as the counting predicts, which the driver holds to the
instance's launch counter), over those kernels' device time. In
percent; None where no such kernel ran."""

from benchmark.peaks import least_seconds


def read(run):
    if run.probe is None or "attention_flops" not in run.work:
        return None
    d80_s = run.probe.kernel_s(lambda n: "attention_kernel_d80" in n)
    if d80_s <= 0:
        return None
    least, _ = least_seconds(run.work["attention_flops"],
                             run.work["attention_bytes"], "bfloat16")
    return 100.0 * least / d80_s
