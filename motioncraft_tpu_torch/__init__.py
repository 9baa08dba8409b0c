"""motioncraft_tpu_torch — the PyTorch/CUDA port of motioncraft_tpu.

The JAX package ``motioncraft_tpu`` stays the reference; this package does
the same work in PyTorch on an NVIDIA H100, with a hand-written Hopper CUDA
kernel in place of every Pallas kernel on its path.  It imports nothing of
JAX and nothing of ``motioncraft_tpu``.

Layer map:
  config/registry  -> motioncraft_tpu_torch.config / .registry
  diffusion        -> motioncraft_tpu_torch.diffusion (DDIM and RePaint
                      sampling loops, training targets, timestep samplers)
  denoiser         -> motioncraft_tpu_torch.models
  kernels          -> motioncraft_tpu_torch.ops (wrappers) + csrc/ (CUDA)
  optimizer state  -> motioncraft_tpu_torch.parallel
  test/train API   -> motioncraft_tpu_torch.apis (+ the eval hook, the
                      windowed long-form sampler)
  data             -> motioncraft_tpu_torch.data (datasets, pipelines, loader)
  evaluation       -> motioncraft_tpu_torch.eval (evaluator model, metrics)
  checkpoints      -> motioncraft_tpu_torch.utils (convert, torch_convert,
                      checkpoint)
  host-side tools  -> motioncraft_tpu_torch.utils (export, web_player,
                      render, fast_render), .ops.humanml3d, .data (bvh,
                      mocap, prep); the visualizer CLIs tools/torch_*visualize.py

Slices ported so far, for STMoGen (``configs/stmogen/t2m_motionx_0_125b.py``):
text-to-motion DDIM sampling with classifier-free guidance, training on one
device, checkpoint I/O and the T2M protocol evaluation (tools/torch_test.py);
and music-to-dance with the ControlNet branch (``ControlT2MHalf``,
``configs/stmogen/m2d_finedance_0125b.py``): windowed RePaint sampling and
its evaluation (tools/torch_m2d_test.py).
"""

__version__ = "0.1.0"

from . import registry  # noqa: F401
from .config import Config  # noqa: F401
