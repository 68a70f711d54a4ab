"""ml_recipe_tpu_torch: the PyTorch/CUDA port of ml_recipe_tpu.

A package of its own beside the JAX one: it imports torch, numpy and the
standard library, never jax or anything of ``ml_recipe_tpu``. This slice
serves the 4-head QA model (``cli/serve.py``); its one hand-written Hopper
kernel is the fused attention forward (``csrc/fused_attention_fwd.cu``).
Entry points run on CUDA unless the caller asks for the CPU.
"""
