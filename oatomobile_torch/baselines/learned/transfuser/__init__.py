"""The TransFuser policy for batched rollouts
(``policy.make_transfuser_policy``).  Neither ``baselines.learned`` nor
``models`` imports it: only what runs TransFuser loads it."""

from oatomobile_torch.baselines.learned.transfuser.policy import (
    TransFuserPolicy, make_transfuser_policy)

__all__ = ["TransFuserPolicy", "make_transfuser_policy"]
