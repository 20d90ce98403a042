"""dropclip_tpu_torch — the PyTorch/CUDA port of ``dropclip_tpu``.

Serves text-grounding queries on one NVIDIA Hopper card: a single-view
cloud is voxelized on the host, MinkUNet runs on the brick engine
(``sparse``), CLIP's text tower encodes the queries (``teachers``) and
paired-softmax grounding (``similarity``) turns per-voxel features into
masks over the input points (``pipeline.GroundingPipeline``).

Every module mirrors the file of the same name in ``dropclip_tpu``; the
JAX package is the reference the port is tested against and is never
imported here. Hand-written kernels: ``kernels/brick_conv3.py`` (CUDA,
``csrc/brick_conv3.cu``) for the k3 submanifold brick conv and
``ops/layernorm.py`` (Triton) for the text tower's LayerNorm. Each has a
plain PyTorch version in the same module, taken only for CPU tensors.
"""

__version__ = "0.1.0"
