"""mm_diffusion_tpu_torch -- the PyTorch / CUDA port of mm_diffusion_tpu.

Joint audio-video diffusion (MM-Diffusion) on an NVIDIA GPU: the MM-UNet
and the 64->256 SR U-Net in PyTorch, the attention kernels hand-written in
CUDA C++ for Hopper (``ops/csrc``), and the flagship sampling path
(``scripts/multimodal_sample_sr.py``).  The JAX package ``mm_diffusion_tpu``
is the reference that the port is tested against.  This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
