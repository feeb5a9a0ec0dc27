"""gdpt_tpu_torch — the PyTorch + CUDA port of gdpt_tpu.

The JAX package `gdpt_tpu` beside this one is the reference; each module
here mirrors its counterpart there (same layout, same names) and is
held against it by the `tests/test_torch_*.py` files. This package
imports torch and numpy only, never jax and nothing of `gdpt_tpu`.

Entry point: ``integrators.render.render(scene, device=None)`` runs on
CUDA unless ``device="cpu"`` is given. On CUDA tensors the ray casts go
through the hand-written Hopper kernels in ``csrc/``; on CPU tensors
they use their plain PyTorch versions.
"""
