from oatomobile_torch.baselines.learned.dim.agent import DIMAgent
from oatomobile_torch.models.dim import ImitativeModel

__all__ = ["DIMAgent", "ImitativeModel"]
