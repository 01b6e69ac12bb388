"""The selective-checkpointing policy of a training iteration
(``RaftStereoConfig.remat_save``), the JAX model's
``save_only_these_names`` policy in PyTorch terms.

Under ``remat_gru`` each iteration after its lookup runs under
``torch.utils.checkpoint`` and the backward recomputes it.  The names in
``remat_save`` keep values of the forward instead, with the JAX package's
meaning; a kept value is the value the recompute would have given, so the
gradients do not change, bit for bit:

* ``"corr_lookup"``: the lookup's output.  The lookup runs before the
  checkpointed region, and its output is one of the region's inputs.
* ``"gru_gates"``: every ConvGRU level's pre-activations ``zr`` and
  ``qpre``.  They come from dispatcher operators a policy can name
  (``create_selective_checkpoint_contexts``), on every call: the gate
  kernel's ``raft_stereo::gru_gates`` (kernels/gru_fused.py) and, on the
  plain path (``fused_gru="off"``), ``raft_stereo::gate_conv`` below, one
  gate convolution with its bias (``GateConv2d``).  The policy keeps their
  outputs, and the recompute takes them without running the kernel or the
  convolutions.
* ``"motion_features"``: the motion encoder's output.  The encoder runs
  before the checkpointed region, once per iteration, its output one of the
  region's inputs; its own backward keeps what it needs (its convolutions'
  inputs), as any module outside a checkpoint does.  The lookup then runs
  outside the region too, its output saved with the encoder's input.  So
  this name keeps more than JAX's ``save_only_these_names`` does (which
  keeps the output and recomputes the lookup): on an H100 +5.2-5.8 GiB at
  ``TrainConfig()`` over ("corr_lookup", "gru_gates"), against ~1.3 GB
  for the output alone; the gradients are the same.

Without ``"gru_gates"`` no policy is passed, and the region is the plain
non-reentrant checkpoint it was.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import create_selective_checkpoint_contexts
from torch.utils.flop_counter import register_flop_formula

# importing the module registers raft_stereo::gru_gates
from raft_stereo_tpu_torch.kernels import gru_fused  # noqa: F401
from raft_stereo_tpu_torch.models.extractor import Conv2d


@torch.library.custom_op("raft_stereo::gate_conv", mutates_args=())
def _gate_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    return _gate_conv_plain(x, weight, bias)


def _gate_conv_plain(x, weight, bias):
    """The port's ``Conv2d`` at a gate: a 3x3 stride-1 conv in ``x``'s
    dtype, then the bias added to its rounded output (NCHW, OIHW)."""
    y = F.conv2d(x, weight.to(x.dtype), None, 1, 1)
    return y + bias.to(x.dtype)[:, None, None]


@_gate_conv.register_fake
def _gate_conv_fake(x, weight, bias):
    return x.new_empty((x.shape[0], weight.shape[0]) + tuple(x.shape[2:]))


def _gate_conv_setup(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.bias_dtype = bias.dtype


def _gate_conv_backward(ctx, grad):
    """The gradients autograd takes through ``_gate_conv_plain``, from the
    same calls: ``convolution_backward`` for the input and the weight (cast
    back to the weight's dtype), the output gradient summed over N, H, W
    for the bias; the forward is not run again."""
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad
    gx = gw = gb = None
    if need_x or need_w:
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad, x, weight.to(x.dtype), None, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [need_x, need_w, False])
        if gw is not None:
            gw = gw.to(weight.dtype)
    if need_b:
        gb = grad.sum((0, 2, 3)).to(ctx.bias_dtype)
    return gx, gw, gb


_gate_conv.register_autograd(_gate_conv_backward,
                             setup_context=_gate_conv_setup)


@register_flop_formula(torch.ops.raft_stereo.gate_conv)
def _gate_conv_flops(x, weight, bias, *args, out_shape=None, **kwargs
                     ) -> int:
    n, cin, h, w = x
    return 2 * n * weight[0] * h * w * cin * weight[2] * weight[3]


class GateConv2d(Conv2d):
    """A ConvGRU gate convolution (``convzr``, ``convq``) on the plain path:
    the port's ``Conv2d`` whose float forward is the
    ``raft_stereo::gate_conv`` operator (the same calls, bit for bit); an
    int8 pack routes as ``Conv2d`` routes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant != "off":
            return super().forward(x)
        return torch.ops.raft_stereo.gate_conv(x, self.weight, self.bias)


# remat_save name -> the operators whose outputs it keeps
SAVED_OPERATORS = {
    "gru_gates": (torch.ops.raft_stereo.gru_gates.default,
                  torch.ops.raft_stereo.gate_conv.default),
}


def context_fn(remat_save: Sequence[str]) -> Optional[functools.partial]:
    """``torch.utils.checkpoint``'s ``context_fn`` for ``remat_save``:
    the selective policy keeping the named operators' outputs, or None
    where no name needs one (the lookup and the motion features are kept
    by running them before the region)."""
    ops = [op for name in remat_save for op in SAVED_OPERATORS.get(name, ())]
    if not ops:
        return None
    return functools.partial(create_selective_checkpoint_contexts, ops)
