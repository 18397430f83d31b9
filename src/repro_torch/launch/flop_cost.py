"""FLOP counting of a step traced on the ``meta`` device, the counterpart of
``repro.launch.jaxpr_cost``.

The step runs on ``meta`` tensors (shapes only, nothing computed): the
kernels' wrappers take their plain versions there, as on the CPU, so the
count is the plain versions' arithmetic.  Two dispatch modes watch it:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the GEMMs and
  convolutions (2·M·N·K a product, batched dims multiplying), the
  backward's included;
* ``_Elementwise`` counts every elementwise and reduction op at 1 FLOP per
  output element — noise next to the GEMMs, as in the JAX walker, but it
  keeps softmax- and norm-heavy graphs honest.

``torch.utils.checkpoint``'s recompute runs through both in the backward,
so rematerialization is counted, as the JAX walker counts ``remat``.  The
shapes are the ones the step is given: a model under a mesh counts one
rank's program on its local shapes.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ELEMWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "neg", "abs", "sign",
    "floor", "ceil", "erf", "pow", "where", "cumsum", "logcumsumexp", "sum", "mean",
    "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "_softmax",
    "_log_softmax", "_softmax_backward_data", "silu", "silu_backward", "gelu",
    "gelu_backward", "softplus", "softplus_backward", "tanh_backward",
    "sigmoid_backward", "reciprocal", "square", "masked_fill", "lerp", "addcmul",
    "addcdiv",
}


class _Elementwise(TorchDispatchMode):
    """1 FLOP per output element of every op in ``ELEMWISE``."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in ELEMWISE:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.flops += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
        return out


def count_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under both counters → (its result,
    {"gemm": GEMM and convolution FLOPs, "elementwise": the rest,
    "total": both})."""
    ew = _Elementwise()
    with FlopCounterMode(display=False) as fc, ew:
        out = fn(*args, **kwargs)
    gemm = int(fc.get_total_flops())
    return out, {"gemm": gemm, "elementwise": int(ew.flops), "total": gemm + int(ew.flops)}


def step_flops(fn, *args) -> int:
    """``fn(*args)``'s FLOPs (the JAX walker's ``step_flops``): trace it on
    the arguments given (``meta`` tensors for a whole model) and count."""
    return count_flops(fn, *args)[1]["total"]
