"""FID and the quality guards (counterpart of ``ddim_cold_tpu/eval``)."""

from ddim_cold_torch.eval.fid import (
    ActivationStats,
    compute_fid,
    fid_between,
    fid_from_stats,
    frechet_distance,
    make_feature_fn,
)
from ddim_cold_torch.eval.inception import InceptionV3Features, load_torch_inception

__all__ = [
    "ActivationStats",
    "compute_fid",
    "fid_between",
    "fid_from_stats",
    "frechet_distance",
    "make_feature_fn",
    "InceptionV3Features",
    "load_torch_inception",
]
