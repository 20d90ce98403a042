"""The serve call's host preparation: the mean per ``ground_batch`` call
(``dropclip.serve.call`` span) of the wall that its
``dropclip.serve.voxelize`` spans cover (centring, ``sparse_quantize_np``
and the gathers of every scene, and the batch's ``np.stack``), in the
traced calls. In ms."""

from benchmark import spans


def read(run):
    return spans.mean_wall_ms(run.probe, "serve.call", "serve.voxelize")
