"""Host data pipeline of the port: datasets, resize, the loader."""

from ddim_cold_torch.data.datasets import ColdDownSampleDataset, DiffusionDataset
from ddim_cold_torch.data.loader import ShardedLoader

__all__ = ["ColdDownSampleDataset", "DiffusionDataset", "ShardedLoader"]
