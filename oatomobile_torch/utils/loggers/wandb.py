"""Weights & Biases logger (optional dependency)."""

from oatomobile_torch.utils.loggers import base


class WandBLogger(base.Logger):
  """Logs to wandb; the run is initialised at construction time, not at
  import."""

  def __init__(self, project: str = "oatomobile-torch", **init_kwargs) -> None:
    import wandb  # Raises ImportError if unavailable.
    self._wandb = wandb
    if wandb.run is None:
      wandb.init(project=project, **init_kwargs)

  def write(self, data: base.LoggingData) -> None:
    self._wandb.log(dict(data))
