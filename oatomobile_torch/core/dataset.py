"""Core dataset API, on-disk episodes of per-step npz samples: a copy of
the JAX package's ``core/dataset.py``."""

import abc
import os
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

from oatomobile_torch.utils.uuid import unique_token_generator

tokens = unique_token_generator()


class Episode:
  """An on-disk episode store: one compressed npz per step plus an ordered
  metadata file of sample tokens."""

  def __init__(self, parent_dir: str, token: str) -> None:
    self._parent_dir = parent_dir
    self._token = token
    self._episode_dir = os.path.join(self._parent_dir, self._token)
    os.makedirs(self._episode_dir, exist_ok=True)
    self._metadata_fname = os.path.join(self._episode_dir, "metadata")

  @property
  def token(self) -> str:
    return self._token

  @property
  def episode_dir(self) -> str:
    return self._episode_dir

  def append(self, **observations: np.ndarray) -> None:
    """Appends ``observations`` to the episode."""
    sample_token = next(tokens)
    np.savez_compressed(
        os.path.join(self._episode_dir, "{}.npz".format(sample_token)),
        **observations)
    with open(self._metadata_fname, "a") as metadata:
      metadata.write("{}\n".format(sample_token))

  def append_batch(self, observations: Mapping[str, np.ndarray]) -> None:
    """Appends a whole trajectory at once.

    Device collection produces time-stacked arrays (leading axis = time);
    this flushes them as per-step samples in one pass.
    """
    lengths = {key: len(value) for key, value in observations.items()}
    num_steps = min(lengths.values())
    for t in range(num_steps):
      self.append(**{key: value[t] for key, value in observations.items()})

  def fetch(self) -> Sequence[str]:
    """Returns all the sample tokens in order."""
    with open(self._metadata_fname, "r") as metadata:
      samples = metadata.read()
    return list(filter(None, samples.split("\n")))

  def read_sample(
      self,
      sample_token: str,
      attr: Optional[str] = None,
  ) -> Union[Mapping[str, np.ndarray], np.ndarray]:
    """Loads and parses an observation or a single attribute."""
    with np.load(
        os.path.join(self._episode_dir, "{}.npz".format(sample_token)),
        allow_pickle=True) as npz_file:
      if attr is not None:
        return npz_file[attr]
      return {key: npz_file[key] for key in npz_file}


class Dataset(abc.ABC):
  """The abstract class for a dataset."""

  def __init__(self, *args: Any, **kwargs: Any) -> None:
    self.uuid = self._get_uuid(*args, **kwargs)

  @abc.abstractmethod
  def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
    """Returns the universal unique identifier of the dataset."""

  @property
  @abc.abstractmethod
  def info(self) -> Mapping[str, Any]:
    """The dataset description."""

  @property
  @abc.abstractmethod
  def url(self) -> str:
    """The URL where the dataset is hosted."""

  @abc.abstractmethod
  def download_and_prepare(self, output_dir: str, *args: Any,
                           **kwargs: Any) -> None:
    """Downloads and prepares the dataset from the host URL."""

  @staticmethod
  @abc.abstractmethod
  def load_datum(fname: str, *args: Any, **kwargs: Any) -> Any:
    """Loads a datum from the dataset."""

  @staticmethod
  @abc.abstractmethod
  def plot_datum(fname: str, output_dir: str, *args: Any,
                 **kwargs: Any) -> None:
    """Visualizes a datum from the dataset."""
