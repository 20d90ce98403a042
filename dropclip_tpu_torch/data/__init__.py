"""Host-side data pipeline: processed datasets, augmentation, loader."""


def build_dataset_for(cfg):
    """Dataset dispatch on cfg.dataset: the MV-TOD (Blender) dataset; the
    REGRAD dataset raises until it is ported."""
    name = (cfg.dataset or "DistilBlender").lower()
    if "regrad" in name:
        raise NotImplementedError(
            "the REGRAD dataset is not ported yet: it waits for its ROADMAP "
            "queue 1 item, the REGRAD dataset")
    from .dataset_blender import build_dataset

    return build_dataset(cfg)
