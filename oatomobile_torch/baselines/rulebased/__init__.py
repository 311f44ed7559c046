"""Rule-based baseline agents."""

from oatomobile_torch.baselines.rulebased.autopilot.agent import \
    AutopilotAgent
from oatomobile_torch.baselines.rulebased.blind.agent import BlindAgent

__all__ = ["AutopilotAgent", "BlindAgent"]
