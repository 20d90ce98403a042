"""Load and run exported grounding artifacts (``tools/export_model.py``).

Port of ``dropclip_tpu/serve.py``: the consumer side of the export. A
serving host needs only this module, which imports nothing but the
registration of K1's op (``torch.ops.dropclip.brick_conv3``): no model
code, no config, no checkpoint. The artifact holds the student's weights
and the grounding arithmetic; text embeddings come from the caller (a
CLIP text tower or a prompt cache).

    from dropclip_tpu_torch.serve import load_exported
    run = load_exported("student_serve.pt2")
    masks, sims, dropped = run(coords, mask, in_feats, qpos, qneg)
"""

from __future__ import annotations

from typing import Callable

import torch

from .kernels import brick_conv3  # noqa: F401  (registers K1's op)


def load_exported(path: str) -> Callable:
    """The artifact at ``path`` as a callable module. Its signature and
    static shapes are those it was exported with (``torch.export.load(
    path).module_call_graph``), on the device it was exported for."""
    return torch.export.load(path).module()
