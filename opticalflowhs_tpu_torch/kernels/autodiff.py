"""Autograd through the kernel entries: a kernel forward and a plain-twin
backward.

Port of the reference's `jax.custom_vjp` scheme (opticalflowhs_tpu/kernels/
derivatives.py `_derivatives_ad`, jacobi.py `_jacobi_sweeps_ad`, sor.py
`_sor_sweeps_ad`, solve_resident.py, solve_robust.py `_solve_ad`,
tvl1_inner.py `_inner_ad`, solve_fused.py, solve_skewed.py,
sor_planes.py): the forward is the kernel, the backward is the VJP of the
entry's plain twin, which recomputes the forward. No backward kernel
exists, in the reference or here.

`KernelEntry` is that scheme as one `torch.autograd.Function`. Its forward
runs the kernel callable with grad off and saves only the tensor inputs.
Its backward re-runs the twin on detached copies of them under
`torch.enable_grad()` (the twins' loops are `stencils.checkpointed_loop`s,
so the tape holds O(sqrt(n)) fields) and returns
`torch.autograd.grad` of the twin's outputs with respect to the inputs
that need a gradient. The backward launches no kernel.

Each entry (K1-K8 and the whole-solve drivers) checks `needs_grad` first
and, when it holds, calls `KernelEntry.apply` with itself as the kernel
callable: inside the Function's forward grad mode is off, so the entry
then takes its kernel path. Forward-mode AD through an entry raises, as the
reference's `custom_vjp` entries do not support `jax.jvp`; the plain
backend supports it.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwad


def needs_grad(*tensors) -> bool:
    """Whether a call on these arguments must go through `KernelEntry`: one
    of them is a CUDA tensor that carries a forward-mode tangent, or that
    requires grad while grad mode is on. CPU tensors take the plain path,
    which torch differentiates itself; None and non-tensors are skipped."""
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            continue
        if t.requires_grad and torch.is_grad_enabled():
            return True
        if fwad.unpack_dual(t).tangent is not None:
            return True
    return False


def _fresh(out: torch.Tensor, inputs) -> torch.Tensor:
    """`out`, or a clone of it where it is a view (K5's result slots) or
    shares memory with an input (an early exit that returns its start):
    autograd then sees a fresh output, and no input is marked dirty."""
    if out._base is not None:
        return out.clone()
    ptr = out.untyped_storage().data_ptr()
    if any(t is not None and t.untyped_storage().data_ptr() == ptr for t in inputs):
        return out.clone()
    return out


class KernelEntry(torch.autograd.Function):
    """apply(kernel, twin, *tensors): kernel(*tensors) forward (grad off),
    the VJP of twin(*tensors) backward. Both callables take the tensors
    (None for an absent start) positionally, with the entry's static
    arguments bound, and return a tuple of tensors."""

    @staticmethod
    def forward(ctx, kernel, twin, *tensors):
        ctx.twin = twin
        ctx.save_for_backward(*tensors)
        return tuple(_fresh(o, tensors) for o in kernel(*tensors))

    @staticmethod
    def backward(ctx, *grads):
        wants = ctx.needs_input_grad[2:]
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(saved, wants)]
            outs = ctx.twin(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        targets = [t for t, w in zip(inputs, wants) if w and t is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], targets,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs and targets else [None] * len(targets))
        return (None, None) + tuple(next(got) if w and t is not None else None
                                    for t, w in zip(inputs, wants))
