"""Parallelism: the device mesh over ``torch.distributed`` and the
data-parallel training update."""

from oatomobile_torch.parallel import dp, mesh

__all__ = ["dp", "mesh"]
