"""Platform switches shared by the port's entry points.

Port of ``dropclip_tpu/core/platform.py``. Of its four functions only
``env_flag`` has a job in PyTorch, and it is defined here. The other
three drive JAX's runtime and have no counterpart (ROADMAP queue 1, item
7.5): ``honor_jax_platforms_env`` makes JAX obey ``JAX_PLATFORMS`` where
a TPU plugin ignores it, and the port's entry points take ``--device``
(``core.device.resolve_device``) instead; ``force_cpu_devices`` makes
virtual CPU devices for a one-program mesh, and the port runs one process
a device (``core.distributed``, gloo processes on the CPU); and
``enable_compile_cache`` keeps XLA's compiled programs, while the port's
nvcc builds are kept by content hash under ``build/kernels/``
(``kernels/nvcc.py``) and Triton keeps its own cache.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: bool = False) -> bool:
    """A boolean switch from the environment: unset or empty gives
    ``default``; "0", "false", "no" and "off" give False (where
    ``bool(os.environ.get(...))`` would take "0" as on)."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "no", "off")
