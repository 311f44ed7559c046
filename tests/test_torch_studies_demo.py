"""``oatomobile_torch.experiments.demo_full_loop`` against the JAX
package's ``scripts/demo_full_loop.py`` on the CPU at a small size: two
collected Town01 episodes of 120 steps, one epoch at batch 4, a
one-scene closed loop of two steps.  The two trainers start from other
initial weights (``ROADMAP.md``, Queue 3: initial weights), so the
summaries are held on their layout and counts: the same keys, the same
number of processed samples (the collection and processing match the
JAX package's), one loss an epoch, both closed-loop entries with their
three numbers, finite.
"""

import json
import math
import os

import torch

from oatomobile_torch.experiments import demo_full_loop
from test_torch_experiments import jax_script

torch.set_num_threads(1)

SIZE = dict(episodes=2, ep_steps=120, epochs=1, batch=4, eval_scenes=1,
            eval_steps=2)


def test_demo_summary_matches_jax_layout(tmp_path):
  roots = {side: str(tmp_path / side) for side in ("jax", "torch")}
  jax_script("demo_full_loop", dict(
      DEMO_OUT=roots["jax"], **{"DEMO_" + k.upper(): v
                                for k, v in SIZE.items()})).main()
  with open(os.path.join(roots["jax"], "summary.json")) as fp:
    want = json.load(fp)
  got = demo_full_loop.run(out=roots["torch"], device="cpu", **SIZE)
  with open(os.path.join(roots["torch"], "summary.json")) as fp:
    assert json.load(fp) == got
  assert list(got) == list(want) == ["num_samples", "train_losses",
                                     "closed_loop"]
  assert got["num_samples"] == want["num_samples"] > 0
  assert len(got["train_losses"]) == len(want["train_losses"]) == 1
  assert list(got["closed_loop"]) == list(want["closed_loop"])
  for name, entry in got["closed_loop"].items():
    assert list(entry) == list(want["closed_loop"][name])
    assert all(math.isfinite(v) for v in entry.values())
  # Resumable: the processed samples exist, nothing is collected again.
  assert os.listdir(os.path.join(roots["torch"], "raw"))
  again = demo_full_loop.run(out=roots["torch"], device="cpu", **SIZE)
  assert again["num_samples"] == got["num_samples"]
