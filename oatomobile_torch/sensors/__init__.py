"""On-device observation synthesis: state readouts, BEV, cameras, game
state."""

from oatomobile_torch.sensors import cameras, synth

__all__ = ["cameras", "synth"]
