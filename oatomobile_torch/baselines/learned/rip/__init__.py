from oatomobile_torch.baselines.learned.rip.agent import RIPAgent

__all__ = ["RIPAgent"]
