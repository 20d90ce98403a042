"""Host-side data helpers: voxelization and synthetic scenes."""
