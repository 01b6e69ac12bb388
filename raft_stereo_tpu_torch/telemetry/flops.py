"""FLOPs of the model, from per-layer formulas.

The JAX package reads an executable's FLOPs from XLA's ``cost_analysis``;
torch has no such report, so the port counts them here from the config,
the padded image shape, the batch and the iteration count.  A FLOP is a
multiply or an add of a multiply-accumulate, ``2 x MACs``, of every
convolution and every matmul (the all-pairs correlation volume, the
volume-free correlation's per-level products, the bilinear resizes
between GRU levels).  Elementwise work, norms,
pooling, resampling and the window lookups count nothing: this is
``torch.utils.flop_counter.FlopCounterMode``'s convention, and the CPU
tests hold these formulas to it exactly on the plain versions.  The hand
kernels do the same work as their plain versions: the gate kernel the two
gate convolutions of a ConvGRU level, the alt kernels the per-level
products (tests/test_torch_costs.py).

Why formulas and not ``FlopCounterMode`` over the model at the real
shape: the model cannot run without real CPU tensors.  The kernel
wrappers take their plain versions only for a CPU tensor and launch (or
refuse) for any other device, meta included; and fake CPU tensors
(``FakeTensorMode``) enter the device-keyed caches of the resize
matrices (ops/resize.py) and calibrated scales (models/corr.py), where a
later real forward at that shape would find them.  A real CPU run at the
full shape does the whole work (5.88 TFLOP for a default pair at 384x1248
and 32 iterations, 71.3 for a default training step).  So the formulas stay,
and the CPU tests hold them to the counter over every preset with every
corr_backend, the quantized tiers and each option that changes the
convs (n_gru_layers, slow_fast_gru, n_downsample, remat).

A training step counts the forward over every iteration, the backward
(each convolution or matmul again for its weight gradient and again for
its input gradient where the input needs one, the images and the
detached flow do not), the ConvGRU gates' backward (the gate op re-runs
its plain twin before differentiating it), and, under ``remat_gru``, the
recompute of every iteration less what ``remat_save`` keeps: the lookup
(``corr_lookup``, and ``motion_features``, which runs the lookup and the
motion encoder before the checkpointed region), the gate convs
(``gru_gates``), the motion encoder (``motion_features``).
"""

from __future__ import annotations

from typing import Iterator, Tuple

# (flops of the op, the multiple of them its backward does, part of the
# step) where the part is "encoder" (once per pair), "lookup" (per
# iteration, before the checkpointed update), "gates" (the ConvGRU gate
# convs), "motion" (the motion encoder) or "update" (the rest of an
# iteration)
_Op = Tuple[int, int, str]


def conv_flops(n: int, cin: int, cout: int, k: int, ho: int, wo: int) -> int:
    """2 x MACs of an (n, cin, ., .) -> (n, cout, ho, wo) k x k conv."""
    return 2 * n * cout * ho * wo * cin * k * k


def matmul_flops(batch: int, m: int, k: int, n: int) -> int:
    """2 x MACs of ``batch`` (m, k) x (k, n) products."""
    return 2 * batch * m * k * n


def conv_out(size: int, k: int, stride: int) -> int:
    """Output size of a 'same'-padded (k // 2) conv."""
    return (size + 2 * (k // 2) - k) // stride + 1


class _Convs:
    """Appends the convs of the encoders' building blocks to ``ops``."""

    def __init__(self, ops, part: str, conv_backward: int = 2):
        self.ops, self.part = ops, part
        self.conv_backward = conv_backward

    def conv(self, n, cin, cout, k, h, w, stride=1, grad_input=True):
        """Backward: the weight gradient, and the input gradient where the
        input needs one."""
        ho, wo = conv_out(h, k, stride), conv_out(w, k, stride)
        self.ops.append((conv_flops(n, cin, cout, k, ho, wo),
                         self.conv_backward if grad_input else 1,
                         self.part))
        return ho, wo

    def resize(self, n, c, hw, out_hw):
        """ops/resize.py: one interpolation matmul per axis that changes
        (a constant matrix: the backward is the input gradient only)."""
        (h, w), (oh, ow) = hw, out_hw
        if h != oh:
            self.ops.append((matmul_flops(n * c * w, oh, h, 1), 1,
                             self.part))
        if w != ow:
            self.ops.append((matmul_flops(n * c * oh, ow, w, 1), 1,
                             self.part))

    def residual(self, n, cin, cout, h, w, stride=1):
        ho, wo = self.conv(n, cin, cout, 3, h, w, stride)
        self.conv(n, cout, cout, 3, ho, wo)
        if not (stride == 1 and cin == cout):
            self.conv(n, cin, cout, 1, h, w, stride)
        return ho, wo

    def trunk(self, n, h, w, downsample):
        h, w = self.conv(n, 3, 64, 7, h, w, 1 + (downsample > 2),
                         grad_input=False)
        cin = 64
        for dim, stride in ((64, 1), (96, 1 + (downsample > 1)),
                            (128, 1 + (downsample > 0))):
            h, w = self.residual(n, cin, dim, h, w, stride)
            h, w = self.residual(n, dim, dim, h, w)
            cin = dim
        return h, w


def _ops(cfg, hw: Tuple[int, int], batch: int, iters: int,
         context: bool = True) -> Iterator[_Op]:
    """Every conv and matmul of one forward, with its gradient flag and
    part of the step.  ``context=False``: the forward of a reused context
    bundle (``ctx_init``), where cnet and the context convs do not run."""
    ops = []
    enc = _Convs(ops, "encoder")
    cnet = _Convs(ops if context or cfg.shared_backbone else [], "encoder")
    n, nl, hd = batch, cfg.n_gru_layers, cfg.hidden_dims
    # the trunk(s): the shared backbone runs one trunk over both images
    if cfg.shared_backbone:
        h0, w0 = enc.trunk(2 * n, *hw, cfg.n_downsample)
        enc.residual(2 * n, 128, 128, h0, w0)
        enc.conv(2 * n, 128, cfg.fnet_dim, 3, h0, w0)
    else:
        h0, w0 = cnet.trunk(n, *hw, cfg.n_downsample)
        enc.trunk(2 * n, *hw, cfg.n_downsample)
        enc.conv(2 * n, 128, cfg.fnet_dim, 1, h0, w0)
    # cnet's heads (hidden and context) per level, then the context convs
    sizes = [(h0, w0)]
    for dims in (cfg.hidden_dims, cfg.context_dims):
        cnet.residual(n, 128, 128, h0, w0)
        cnet.conv(n, 128, dims[0], 3, h0, w0)
    h, w = h0, w0
    for level in range(1, nl):
        h, w = cnet.residual(n, 128, 128, h, w, 2)
        h, w = cnet.residual(n, 128, 128, h, w)
        sizes.append((h, w))
        for dims in (cfg.hidden_dims, cfg.context_dims):
            if level == 1:
                cnet.residual(n, 128, 128, h, w)
            cnet.conv(n, 128, dims[level], 3, h, w)
    for level in range(nl):
        cnet.conv(n, cfg.context_dims[level], 3 * hd[level], 3,
                  *sizes[level])
    # the correlation: the all-pairs volume once, or per iteration the
    # volume-free products at each level's pooled width
    d = cfg.fnet_dim
    lookup = []
    if cfg.corr_backend == "alt":
        w2 = w0
        for _ in range(cfg.corr_levels):
            lookup.append((matmul_flops(n * h0, w0, d, w2), 2, "lookup"))
            w2 //= 2
    else:
        ops.append((matmul_flops(n * h0, w0, d, w0), 2, "encoder"))
    # one iteration of the update block: the gate convs ("gates") and the
    # motion encoder ("motion") apart, since remat_save may keep them
    upd = _Convs([], "update")
    # the gate op's backward re-runs its plain twin, then takes both
    # gradients of each conv
    gates = _Convs(upd.ops, "gates",
                   2 if cfg.fused_gru == "off" else 3)
    motion = _Convs(upd.ops, "motion")

    def gru(level, cin_x):
        cin = hd[level] + cin_x
        gates.conv(n, cin, 2 * hd[level], 3, *sizes[level])
        gates.conv(n, cin, hd[level], 3, *sizes[level])

    def gru16():
        if nl > 2:
            upd.resize(n, hd[2], sizes[2], sizes[1])
        gru(1, hd[0] + (hd[2] if nl > 2 else 0))

    gru32 = (lambda: gru(2, hd[1])) if nl == 3 else (lambda: None)
    if nl < 2:
        gru16 = (lambda: None)  # noqa: F811
    if cfg.slow_fast_gru:
        if nl == 3:
            gru32()
        if nl >= 2:
            gru32()
            gru16()
    gru32()
    gru16()
    motion.conv(n, cfg.corr_channels, 64, 1, h0, w0)
    motion.conv(n, 64, 64, 3, h0, w0)
    motion.conv(n, 2, 64, 7, h0, w0, grad_input=False)   # the detached flow
    motion.conv(n, 64, 64, 3, h0, w0)
    motion.conv(n, 128, 126, 3, h0, w0)
    if nl > 1:
        upd.resize(n, hd[1], sizes[1], sizes[0])
    gru(0, 128 + (hd[1] if nl > 1 else 0))
    upd.conv(n, hd[0], 256, 3, h0, w0)                # flow head
    upd.conv(n, 256, 2, 3, h0, w0)
    upd.conv(n, hd[0], 256, 3, h0, w0)                # mask head
    upd.conv(n, 256, cfg.mask_channels, 1, h0, w0)
    yield from ops
    for _ in range(iters):
        yield from lookup
        yield from upd.ops


def forward_flops(cfg, hw: Tuple[int, int], batch: int, iters: int,
                  context: bool = True) -> int:
    """FLOPs of one test-mode forward of ``batch`` pairs padded to ``hw``
    at ``iters`` iterations (the depth cap under early exit);
    ``context=False`` for a forward that reuses a context bundle."""
    return sum(f for f, _, _ in _ops(cfg, hw, batch, iters, context))


def train_step_flops(cfg, hw: Tuple[int, int], batch: int,
                     iters: int) -> int:
    """FLOPs of one training step (module docstring) at crop ``hw``."""
    remat = set()
    if cfg.remat_gru:
        saves = set(cfg.remat_save)
        remat.add("update")
        if "gru_gates" not in saves:
            remat.add("gates")
        if "motion_features" not in saves:
            remat.add("motion")
            if "corr_lookup" not in saves:
                remat.add("lookup")
    return sum(f * (1 + backward + (part in remat))
               for f, backward, part in _ops(cfg, hw, batch, iters))
