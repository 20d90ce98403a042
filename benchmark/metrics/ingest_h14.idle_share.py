"""The card's idle share over the traced ViT-H/14 ingest scenes: one less
the union of its kernel, copy and fill intervals over the traced wall
time. In percent."""


def read(run):
    if run.probe is None or "attention_flops" not in run.work:
        return None
    return 100.0 * (1.0 - run.probe.busy_s() / run.probe.window_s)
