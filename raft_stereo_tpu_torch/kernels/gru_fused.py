"""Fused ConvGRU gate pre-activations: CUDA kernel and its plain version.

``gru_gates_fused(h, x, cr, wzr, bzr, wq, bq) -> (zr, qpre)`` keeps the
JAX package's signature (NHWC activations, HWIO weights):

    zr   = conv3x3([h, x], Wzr) + bzr
    r    = sigmoid(zr[..., Ch:] + cr)
    qpre = conv3x3([r*h, x], Wq) + bq

On CUDA tensors it launches ``csrc/gru_gates.cu`` (two kernel launches
per call: zr with r*h, then qpre; tensor cores, bf16 on wgmma and fp32 as
3xTF32); on CPU tensors it runs the plain version ``_gates_reference``.
Activations are fp32 or bf16; the weights are cast to that dtype and
packed K-major for the kernel (``pack_weights``; fp32 as TF32 high and
low planes), once per weight tensor and version (``_packed``), and the
biases ride fp32, as the JAX op casts them.  The sigmoid/tanh/blend tail
stays with the caller (models/update.py).

The op is the dispatcher operator ``raft_stereo::gru_gates`` with its
autograd registered, as the JAX op's custom VJP is: the forward saves only
its inputs, and the backward recomputes ``_gates_twin`` under
``torch.enable_grad()`` and returns its VJP.  As an operator it is a
boundary a selective-checkpoint policy can name: ``remat_save``
"gru_gates" keeps its outputs (models/remat.py).  The twin is the JAX ``_gates_reference`` (weights and
biases cast to the activation dtype, conv and bias add in that dtype), not
the kernel's rounding mirror ``_gates_reference`` of this module: in fp32
the two are one function, in bf16 the JAX gradients are the twin's.  The
backward's convs are PyTorch's (cuDNN on the card), as the JAX backward's
are XLA's; there is no backward kernel on the TPU either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula
from torch.utils.weak import WeakIdKeyDictionary

from raft_stereo_tpu_torch.kernels import _build

CHANNEL_MULTIPLE = 8  # 16 bytes of bf16: the kernel's gather unit


def _conv3x3_same(inp: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC input, HWIO kernel, stride 1, padding 1 -> NHWC."""
    y = F.conv2d(inp.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def _gates_reference(h, x, cr, wzr, bzr, wq, bq):
    """Plain version of the gate op, with the kernel's rounding points:
    weights cast to the activation dtype, convs and fp32 biases in fp32,
    r from the unrounded zr, r*h rounded to the activation dtype before the
    q conv, zr and qpre rounded once.  In fp32 every cast is a no-op."""
    dt = h.dtype
    ch = h.shape[-1]
    zr = (_conv3x3_same(torch.cat([h, x], dim=-1).float(), wzr.to(dt).float())
          + bzr.float())
    r = torch.sigmoid(zr[..., ch:] + cr.float())
    rh = (r * h.float()).to(dt).float()
    qpre = (_conv3x3_same(torch.cat([rh, x.float()], dim=-1),
                          wq.to(dt).float()) + bq.float())
    return zr.to(dt), qpre.to(dt)


def _gates_twin(h, x, cr, wzr, bzr, wq, bq):
    """The JAX package's plain twin of the gate op, the point its backward
    linearises: weights and biases cast to the activation dtype, each conv
    and each bias add in that dtype."""
    dt = h.dtype
    ch = h.shape[-1]
    zr = (_conv3x3_same(torch.cat([h, x], dim=-1), wzr.to(dt))
          + bzr.to(dt))
    r = torch.sigmoid(zr[..., ch:] + cr)
    qpre = (_conv3x3_same(torch.cat([r * h, x], dim=-1), wq.to(dt))
            + bq.to(dt))
    return zr, qpre


def _gates_vjp(inputs, grads, needs):
    """VJP of ``_gates_twin`` at ``inputs`` (h, x, cr, wzr, bzr, wq, bq)
    for the output gradients ``grads`` (gzr, gqpre); ``None`` for the
    inputs ``needs`` marks False."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = _gates_twin(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads,
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 fraction bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the result are
    zero."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(t), lo = tf32(t - hi): hi + lo is within
    2^-22 of t, relative."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def pack_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the kernel's K-major operand: cast to
    ``dtype``, Cin zero-padded to a multiple of 16 (Cin'), and regrouped
    as (9, Cin'/E, Cout, E), E the values of ``dtype`` in 16 bytes; for
    fp32 two such planes stacked, the TF32 high and low parts
    (``split_tf32``)."""
    kh, kw, cin, cout = w.shape
    cin16 = -(-cin // 16) * 16
    e = 16 // torch.empty((), dtype=dtype).element_size()

    def regroup(t):
        t = F.pad(t, (0, 0, 0, cin16 - cin))
        return t.reshape(kh * kw, cin16 // e, e, cout).permute(
            0, 1, 3, 2).contiguous()

    if dtype == torch.float32:
        return torch.stack([regroup(p) for p in split_tf32(w)])
    return regroup(w.to(dtype))


_PACKS = WeakIdKeyDictionary()  # weight owner -> {key: (version, pack)}


def _packed(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_weights(w, dtype)``, cached per tensor that owns ``w``'s
    storage (its view base, else ``w``; held weakly, so the entry dies
    with the weights and a new tensor that reuses the address is never
    mistaken for the old one) and keyed on the storage pointer, shape,
    strides and dtypes.  An entry holds while the version counter, which
    views share with their base, is unchanged: inference packs once per
    model, training once per optimizer update."""
    owner = w if w._base is None else w._base
    key = (w.data_ptr(), tuple(w.shape), tuple(w.stride()), w.dtype, dtype)
    cache = _PACKS.setdefault(owner, {})
    hit = cache.get(key)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    with torch.no_grad():
        packed = pack_weights(w.detach(), dtype)
    cache[key] = (w._version, packed)
    gru_gates_fused.packs += 1
    return packed


TILE_W = 16  # output columns of a block's tile (kTW in csrc/gru_gates.cu)


def blocks(shape: Tuple[int, int, int], cout: int, bn: int, wg: int,
           ks: int = 1) -> int:
    """Blocks of one launch over ``shape`` = (B, H, W) output pixels and
    ``cout`` channels with tile (BN, WG, KS): 4*WG rows by TILE_W columns
    of pixels by BN channels, K split over KS blocks of a cluster."""
    b, h, w = shape
    return ks * b * -(-h // (4 * wg)) * -(-w // TILE_W) * -(-cout // bn)


# The tiles (BN, WG, KS) of csrc/gru_gates.cu, largest first.
TILES = ((128, 2, 1), (128, 2, 2), (64, 2, 2), (64, 1, 2))


def tile(shape: Tuple[int, int, int], cout: int,
         sms: int) -> Tuple[int, int, int]:
    """(BN, WG, KS) of one launch: the first of ``TILES`` that gives at
    least 90% of the SMs a block, else the smallest.  Fewer pixels per
    block and K split over a cluster shorten each block's chain of
    stages, which sets the time of the small GRU levels."""
    for t in TILES:
        if 10 * blocks(shape, cout, *t) >= 9 * sms:
            return t
    return TILES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ENTRIES = {torch.float32: "raft_gru_gates",
            torch.bfloat16: "raft_gru_gates_bf16"}


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def smem_bytes(dtype: torch.dtype, bn: int, wg: int) -> int:
    """Dynamic shared memory of one gate block (the kernel's own count)."""
    fn = _build.entry("gru_gates", "raft_gru_gates_smem_bytes",
                      [ctypes.c_int] * 3)
    return fn(int(dtype == torch.bfloat16), bn, wg)


def _launch(h, x, cr, wzr, bzr, wq, bq):
    dt = h.dtype
    b, hh, ww, ch = h.shape
    args = {"h": h, "x": x, "cr": cr, "bzr": bzr, "bq": bq}
    args = {k: v.contiguous() for k, v in args.items()}
    args["wzr"], args["wq"] = _packed(wzr, dt), _packed(wq, dt)
    zr = torch.empty((b, hh, ww, 2 * ch), device=h.device, dtype=dt)
    qpre = torch.empty((b, hh, ww, ch), device=h.device, dtype=dt)
    rh = torch.empty_like(qpre)
    with torch.cuda.device(h.device):
        sms = _sm_count(torch.cuda.current_device())
        err = _build.entry("gru_gates", _ENTRIES[dt], _ARGTYPES)(
            *(args[k].data_ptr() for k in
              ("h", "x", "cr", "wzr", "bzr", "wq", "bq")),
            zr.data_ptr(), qpre.data_ptr(), rh.data_ptr(),
            b, hh, ww, ch, x.shape[-1],
            (ctypes.c_int * 6)(*tile((b, hh, ww), 2 * ch, sms),
                               *tile((b, hh, ww), ch, sms)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gru_gates")
    gru_gates_fused.launches += 1
    return zr, qpre


@torch.library.custom_op("raft_stereo::gru_gates", mutates_args=())
def _gates_op(h: torch.Tensor, x: torch.Tensor, cr: torch.Tensor,
              wzr: torch.Tensor, bzr: torch.Tensor, wq: torch.Tensor,
              bq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if h.device.type == "cpu":
        return _gates_reference(h, x, cr, wzr, bzr, wq, bq)
    return _launch(h, x, cr, wzr, bzr, wq, bq)


@_gates_op.register_fake
def _gates_op_fake(h, x, cr, wzr, bzr, wq, bq):
    b, hh, ww, ch = h.shape
    return (h.new_empty((b, hh, ww, 2 * ch)), h.new_empty((b, hh, ww, ch)))


def _gates_op_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gates_op_backward(ctx, gzr, gqpre):
    return _gates_vjp(ctx.saved_tensors, (gzr, gqpre), ctx.needs_input_grad)


_gates_op.register_autograd(_gates_op_backward, setup_context=_gates_op_setup)


@register_flop_formula(torch.ops.raft_stereo.gru_gates)
def _gates_op_flops(h, x, cr, wzr, *args, out_shape=None, **kwargs) -> int:
    """The two gate convolutions' 2 x MACs (FlopCounterMode's count of the
    plain version)."""
    b, hh, ww, ch = h
    return 2 * b * hh * ww * 9 * wzr[2] * 3 * ch


def gru_gates_fused(h: torch.Tensor, x: torch.Tensor, cr: torch.Tensor,
                    wzr: torch.Tensor, bzr: torch.Tensor, wq: torch.Tensor,
                    bq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate pre-activations of one ConvGRU level.

    Args:
      h:  (B,H,W,Ch) hidden state;  x: (B,H,W,Cx) GRU inputs;
      cr: (B,H,W,Ch) r-gate context bias; all three fp32, or all bf16.
      wzr, bzr: (3,3,Ch+Cx,2Ch), (2Ch,);  wq, bq: (3,3,Ch+Cx,Ch), (Ch,);
      weights fp32 or in the activation dtype, biases fp32.

    Returns (zr (B,H,W,2Ch), qpre (B,H,W,Ch)) in the activation dtype,
    differentiable in every input.  Counts its calls that launch the
    kernel in ``gru_gates_fused.launches``; a recompute under
    ``torch.utils.checkpoint`` launches, and counts, again, unless the
    checkpoint's policy keeps this operator's outputs."""
    if h.device.type != "cpu":
        _check(h, x, cr, wzr, bzr, wq, bq)
    return torch.ops.raft_stereo.gru_gates(h, x, cr, wzr, bzr, wq, bq)


gru_gates_fused.launches = 0
gru_gates_fused.packs = 0    # weight packings (``_packed``), not launches


def _check(h, x, cr, wzr, bzr, wq, bq) -> None:
    """Raise on what the kernel does not take (CUDA tensors)."""
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    b, hh, ww, ch = h.shape
    cx = x.shape[-1]
    cin = ch + cx
    expect = {"h": (b, hh, ww, ch), "x": (b, hh, ww, cx),
              "cr": (b, hh, ww, ch), "wzr": (3, 3, cin, 2 * ch),
              "bzr": (2 * ch,), "wq": (3, 3, cin, ch), "bq": (ch,)}
    args = {"h": h, "x": x, "cr": cr, "wzr": wzr, "bzr": bzr, "wq": wq,
            "bq": bq}
    dt = h.dtype
    if dt not in _ENTRIES:
        raise TypeError(f"the gate kernel takes float32 or bfloat16; h is "
                        f"{dt}")
    allowed = {"h": (dt,), "x": (dt,), "cr": (dt,),
               "wzr": (torch.float32, dt), "wq": (torch.float32, dt),
               "bzr": (torch.float32,), "bq": (torch.float32,)}
    for name, t in args.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{expect[name]}")
        if t.dtype not in allowed[name]:
            raise TypeError(f"the gate kernel with {dt} activations takes "
                            f"{name} in {allowed[name]}, got {t.dtype}")
        if t.device != h.device:
            raise ValueError("all gate operands must share one device")
    if ch % CHANNEL_MULTIPLE or cx % CHANNEL_MULTIPLE:
        raise ValueError(f"the gate kernel needs Ch ({ch}) and Cx ({cx}) "
                         f"to be multiples of {CHANNEL_MULTIPLE}")
