"""Gradient by recomputation through a kernel's plain version.

The Pallas kernels K5 and K6 have no backward kernel: their ``custom_vjp``
runs the forward kernel and, for the gradient, recomputes the jnp reference
and takes its VJP.  ``with_recomputed_grad`` restates that with a
``torch.autograd.Function``: the forward calls ``kernel`` and saves its
inputs; the backward recomputes ``plain`` on them under grad mode and
returns ``torch.autograd.grad`` of it.  The recompute runs in the saved
operands' own dtype (bf16 for K6's bf16 instantiation), as the custom VJP
takes the reference's VJP on the residuals it saved.
"""

from __future__ import annotations

from typing import Callable

import torch


class _RecomputeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, needs)]
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = ctx.plain(*inputs)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (None, None, *(next(grads) if x.requires_grad else None for x in inputs))


def with_recomputed_grad(kernel: Callable, plain: Callable, *inputs: torch.Tensor
                         ) -> torch.Tensor:
    """``kernel(*inputs)``, differentiable: its gradient is that of
    ``plain`` (the same function), recomputed in the backward pass."""
    return _RecomputeGrad.apply(kernel, plain, *inputs)
