"""spef_tpu_torch — the PyTorch / CUDA port of ``spef_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax``, ``flax`` or ``spef_tpu``.  Module names mirror ``spef_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every hand-written kernel's wrapper runs its plain PyTorch version.

Importing the package imports nothing else: pull in submodules directly.
"""
