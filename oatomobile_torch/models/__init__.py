"""Neural network building blocks and baseline models: the port of the
JAX package's ``models/`` (NCHW; weights from ``models.convert`` or from
flax-like initialisers seeded by a ``torch.Generator``)."""

from oatomobile_torch.models import transforms
from oatomobile_torch.models.cil import BehaviouralModel
from oatomobile_torch.models.dim import ImitativeModel
from oatomobile_torch.models.mlp import MLP
from oatomobile_torch.models.perception import MobileNetV2
from oatomobile_torch.models.sequence import AutoregressiveFlow

__all__ = [
    "MLP",
    "MobileNetV2",
    "AutoregressiveFlow",
    "BehaviouralModel",
    "ImitativeModel",
    "transforms",
]
