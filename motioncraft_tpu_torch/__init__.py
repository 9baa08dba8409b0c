"""motioncraft_tpu_torch — the PyTorch/CUDA port of motioncraft_tpu.

The JAX package ``motioncraft_tpu`` stays the reference; this package does
the same work in PyTorch on an NVIDIA H100, with a hand-written Hopper CUDA
kernel in place of every Pallas kernel on its path.  It imports nothing of
JAX and nothing of ``motioncraft_tpu``.

Layer map:
  config/registry  -> motioncraft_tpu_torch.config / .registry
  diffusion        -> motioncraft_tpu_torch.diffusion (DDIM sampling loop)
  denoiser         -> motioncraft_tpu_torch.models
  kernels          -> motioncraft_tpu_torch.ops (wrappers) + csrc/ (CUDA)
  test API         -> motioncraft_tpu_torch.apis

Slice ported so far: text-to-motion DDIM sampling with classifier-free
guidance for STMoGen (``configs/stmogen/t2m_motionx_0_125b.py``).
"""

__version__ = "0.1.0"

from . import registry  # noqa: F401
from .config import Config  # noqa: F401
