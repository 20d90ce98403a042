"""The ingested scenes' share of the card's bf16 peak (989 TFLOP/s): the
teacher's work on every scene of the traced run's measured window (each
present (view, object) crop through the vision tower's linears and its
attention's two products, and the fusion queries' text encodes; counted
from the inputs by ``benchmark/counting_vit.py``), over the window's
wall time. In percent."""

from benchmark.peaks import least_seconds


def read(run):
    if "window_flops" not in run.work:
        return None
    least, _ = least_seconds(run.work["window_flops"], 0, "bfloat16")
    return 100.0 * least / run.work["window_s"]
