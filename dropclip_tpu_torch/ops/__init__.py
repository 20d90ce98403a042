"""Kernel-backed tensor ops (``layernorm``: K6 in Triton)."""
