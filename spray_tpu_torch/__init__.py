"""spray_tpu_torch: the PyTorch + CUDA port of the spray_tpu ray tracer.

The module layout mirrors ``spray_tpu`` so each counterpart is found by path.
This package imports torch and numpy only; it never imports jax or spray_tpu.
Entry points take ``device=None``, which means the CUDA card; they raise when
no card is present instead of falling back to the CPU.  Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
