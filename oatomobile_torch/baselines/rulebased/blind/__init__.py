from oatomobile_torch.baselines.rulebased.blind.agent import BlindAgent

__all__ = ["BlindAgent"]
