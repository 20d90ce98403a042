"""Sparse-voxel engine: brick topology, brick ops, MinkUNet on bricks."""
