"""lvd_tpu_torch — the PyTorch/CUDA port of lvd_tpu for one NVIDIA H100.

The JAX package ``lvd_tpu`` is the reference; this package imports nothing
of it (nor ``jax``). Public functions keep lvd_tpu's layouts so the two can be
compared tensor for tensor: latents are channels-last ``(B, F, h, w, C)``,
attention inputs head-packed ``(B, S, H*64)``, the temporal stream
``(B, F, P, C)``; linear weights are ``(din, dout)`` and convolutions HWIO.

Every Pallas kernel lvd_tpu runs on the guided text-to-video path (the
forwards and the backwards the cross-attention energy's gradient needs) has
a hand-written CUDA C++ counterpart under ``csrc/``, built with ``nvcc`` into
one shared library at first use (``ops/_build.py``) and called through
``ctypes``. Each kernel wrapper is a ``torch.autograd.Function`` that runs
its plain PyTorch versions only for CPU tensors; on a CUDA tensor it
launches the kernels or raises.
"""

__version__ = "0.1.0"
