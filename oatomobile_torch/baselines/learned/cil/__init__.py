from oatomobile_torch.baselines.learned.cil.agent import CILAgent
from oatomobile_torch.models.cil import BehaviouralModel

__all__ = ["CILAgent", "BehaviouralModel"]
