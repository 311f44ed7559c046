"""Training on one device (``dp``); the device mesh and the layouts over
several cards are not ported yet."""

from oatomobile_torch.parallel import dp

__all__ = ["dp"]
