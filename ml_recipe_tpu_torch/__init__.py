"""ml_recipe_tpu_torch: the PyTorch/CUDA port of ml_recipe_tpu.

A package of its own beside the JAX one: it imports torch, numpy and the
standard library, never jax or anything of ``ml_recipe_tpu``. It serves the
4-head QA model (``cli/serve.py``) and trains it (``cli/train.py``); its
hand-written Hopper kernels are the fused attention forward and backward
(``csrc/fused_attention_fwd.cu``, ``csrc/fused_attention_bwd.cu``). Entry
points run on CUDA unless the caller asks for the CPU.
"""
