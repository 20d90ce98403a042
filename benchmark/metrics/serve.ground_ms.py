"""The grounding loop's host enqueue: the mean per ``ground_batch`` call
(``dropclip.serve.call`` span) of the wall of its
``dropclip.serve.ground`` span (the per-scene, per-query
``predict_from_embeddings`` calls and their ``torch.stack``s, before the
read back), in the traced calls. In ms."""

from benchmark import spans


def read(run):
    return spans.mean_wall_ms(run.probe, "serve.call", "serve.ground")
