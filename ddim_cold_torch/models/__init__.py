from ddim_cold_torch.models.vit import (
    MODEL_CONFIGS,
    DiffusionViT,
    positionalencoding1d,
    sp_clone,
)

__all__ = ["DiffusionViT", "MODEL_CONFIGS", "positionalencoding1d", "sp_clone"]
