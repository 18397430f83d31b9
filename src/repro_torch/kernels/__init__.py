"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package has ``ops.py`` (the public wrapper: operand checks, the launch
through ``_build`` and a plain-int ``launches`` counter on the wrapper) and
``ref.py`` (the plain PyTorch version, which the wrapper takes for CPU
tensors).  The two kernels of the training path, ``lora_fused`` and
``flash_attn``, also have an autograd Function in ``ops.py``: the kernel as
its forward, a plain-torch backward.  The CUDA sources live in
``repro_torch/csrc``.
"""
