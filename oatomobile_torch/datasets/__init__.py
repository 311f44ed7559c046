"""Public API for `oatomobile_torch.datasets`."""

from oatomobile_torch.datasets.carla import CARLADataset

__all__ = ["CARLADataset"]
