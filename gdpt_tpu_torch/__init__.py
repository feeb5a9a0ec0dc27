"""gdpt_tpu_torch — the PyTorch + CUDA port of gdpt_tpu.

The JAX package `gdpt_tpu` beside this one is the reference; each module
here mirrors its counterpart there (same layout, same names) and is
held against it by the `tests/test_torch_*.py` files. This package
imports torch and numpy only, never jax and nothing of `gdpt_tpu`.

Entry points: ``python -m gdpt_tpu_torch scene.xml -o out.exr`` (cli.py)
and ``integrators.render.render(scene, device=None)`` run on CUDA unless
the CPU is asked for (``--device cpu``, ``device="cpu"``). On CUDA tensors the ray casts go
through the hand-written Hopper kernels in ``csrc/``; on CPU tensors
they use their plain PyTorch versions.
"""
