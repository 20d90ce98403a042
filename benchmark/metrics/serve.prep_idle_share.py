"""The card's idle time while the host prepares a call's input or
unpacks its output: idle time inside the ``dropclip.serve.voxelize`` and
``dropclip.serve.to_points`` spans (no kernel, copy or fill running),
over the traced window's wall time. In percent."""

from benchmark import spans


def read(run):
    if spans.units(run.probe, "serve.call") is None:
        return None
    prep = spans.named(run.probe, lambda n: n in ("serve.voxelize",
                                                  "serve.to_points"))
    return 100.0 * spans.idle_within(run.probe, prep) / run.probe.window_s
