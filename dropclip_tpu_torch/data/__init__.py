"""Host-side data pipeline: raw readers, processed datasets, augmentation,
loader."""


def build_dataset_for(cfg, device=None):
    """Dataset dispatch on cfg.dataset: REGRAD or MV-TOD (Blender);
    ``device`` runs the MV-TOD dataset's ``use_view_clip`` teacher (the
    card unless the caller asks for the CPU)."""
    name = (cfg.dataset or "DistilBlender").lower()
    if "regrad" in name:
        from .dataset_regrad import build_dataset

        return build_dataset(cfg)
    from .dataset_blender import build_dataset

    return build_dataset(cfg, device=device)
