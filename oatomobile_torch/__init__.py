"""`oatomobile_torch`: the PyTorch/CUDA port of `oatomobile_tpu`.

The JAX package beside it stays the reference: every module here keeps
the name of its JAX counterpart and is held against it by the tests
(``tests/test_torch_*.py``).  This package imports torch and numpy only,
never jax or anything of ``oatomobile_tpu``.

Entry points (``envs.batched.BatchedEnv``, ``sim.make_params``,
``sim.init_scene_batch``, ``python -m oatomobile_torch.bench``) run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
