"""The train step's share of the card's peak in the student's dtype
(float32 at 3xTF32's 165 TFLOP/s): every conv's forward, input and
weight gradient (the stem's input takes none) over all the steps of the
traced run's measured window, counted from the benchmark's coordinates,
over the window's wall time. In percent."""

from benchmark.peaks import least_seconds


def read(run):
    if "window_flops" not in run.work:
        return None
    least, _ = least_seconds(run.work["window_flops"], 0, run.work["dtype"])
    return 100.0 * least / run.work["window_s"]
