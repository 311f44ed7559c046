from oatomobile_torch.baselines.rulebased.autopilot.agent import \
    AutopilotAgent

__all__ = ["AutopilotAgent"]
