"""Point-cloud geometry: transforms, projections, voxelization, multi-view aggregation."""
