#!/usr/bin/env python3
"""Design measurements of two of the port's CUDA kernels, on the card.

    python3 tools/torch_kernel_variants.py [--what alt|lookup-bwd|all]

``alt``: the no-volume correlation forward (``csrc/corr_alt.cu``) at the
realtime shapes (1x48 rows, W1 156, W2 156/78/39/19, and the training
step's 8x40 rows, W1 90, W2 90/45/22/11; D 256), on random centers and
on a coherent disparity field (``chip_smoke.coherent_centers``): bf16 on
the tensor cores beside the same kernel built with its dots on the CUDA
cores, then fp32 and bf16 under other plans (pixel tile, channel chunk,
band rows per pass) than ``plan_fwd``'s.  Times by 20 calls per CUDA-graph
replay with the L2 flushes subtracted.

``lookup-bwd``: the pyramid-lookup backward (``csrc/corr_lookup.cu``) at
the default training shape (640 rows, W1 180, W2 180/90/45/22, fp32) by
one-call graph replay, beside variants that store zeros only (no window
lookups) or store nothing, and a memset of the same bytes of dV.

Variants are built from the checkout's sources with one substitution each
into ``raft_stereo_tpu_torch/_build/variants/``.  Needs a CUDA card and
the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (timing helpers and the coherent field)
from raft_stereo_tpu_torch.kernels import _build  # noqa: E402
from raft_stereo_tpu_torch.kernels import corr_alt, corr_lookup  # noqa: E402
from raft_stereo_tpu_torch.models.corr import pool_axis  # noqa: E402

VARIANTS = _build.BUILD_DIR / "variants"


def variant(name: str, source: str, subs) -> ctypes.CDLL:
    """``csrc/<source>.cu`` with each (old, new) substitution applied,
    built and loaded."""
    text = _build.sources()[source].read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in {source}.cu")
        text = text.replace(old, new)
    VARIANTS.mkdir(parents=True, exist_ok=True)
    src, lib = VARIANTS / f"{name}.cu", VARIANTS / f"{name}.so"
    src.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def alt_call(lib, entry, f1, pyr, c, plan):
    """One launch of an alt forward entry of ``lib`` under ``plan``."""
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = corr_alt._ARGTYPES, ctypes.c_int
    b, h, w1, d = f1.shape
    levels = len(pyr)
    out = torch.empty((b, h, w1, levels * (2 * chip_smoke.RADIUS + 1)),
                      device=f1.device, dtype=f1.dtype)
    err = fn(f1.data_ptr(), (ctypes.c_void_p * levels)(
        *[v.data_ptr() for v in pyr]), (ctypes.c_int * levels)(
        *[v.shape[2] for v in pyr]), levels, c.data_ptr(), out.data_ptr(),
        b * h * w1, w1, d, chip_smoke.RADIUS, 1.0 / math.sqrt(d), *plan,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry)
    return out


def alt(dev, gen, flush) -> None:
    key = ("struct FwdTraits<__nv_bfloat16> {\n  using S = __nv_bfloat16;\n"
           "  static constexpr bool kTensor = true;")
    cuda_cores = variant("alt_bf16_cuda_cores", "corr_alt",
                         [(key, key.replace("true", "false"))])
    tensor_cores = _build.load("corr_alt")
    entries = {torch.float32: "raft_corr_alt_f32",
               torch.bfloat16: "raft_corr_alt_bf16"}
    for shape, dtypes in (((1, 48, 156), (torch.bfloat16, torch.float32)),
                          ((8, 40, 90), (torch.bfloat16,))):
        b, h, w = shape
        for dtype in dtypes:
            f1 = torch.randn((b, h, w, 256), generator=gen).to(dev, dtype)
            pyr = [torch.randn((b, h, w, 256), generator=gen).to(dev, dtype)]
            for _ in range(chip_smoke.LEVELS - 1):
                pyr.append(pool_axis(pyr[-1], axis=2).contiguous())
            w2s = [v.shape[2] for v in pyr]
            best = corr_alt.plan_fwd(w2s, chip_smoke.RADIUS, 256, dtype)
            fields = {"random": (torch.rand(shape, generator=gen) * (w + 20)
                                 - 10).to(dev),
                      "coherent": chip_smoke.coherent_centers(
                          gen, b, h, w).to(dev)}
            runs = [("tensor cores" if dtype == torch.bfloat16 else
                     "CUDA cores", tensor_cores, best)]
            if dtype == torch.bfloat16:
                runs.append(("CUDA cores", cuda_cores, best))
            if shape[0] == 1:
                others = ([(32, 256, 64), (16, 256, 80), (32, 64, 304)]
                          if dtype == torch.float32 else
                          [(16, 256, 176), (32, 128, 304)])
                runs += [(f"plan {p}", tensor_cores, p) for p in others]
            for what, lib, plan in runs:
                if plan == best:
                    what += f" (plan_fwd's {plan})"
                for fname, c in fields.items():
                    ms = chip_smoke.graph_each_ms(lambda: alt_call(
                        lib, entries[dtype], f1, pyr, c, plan), flush)
                    print(f"alt {str(dtype)[6:]} {shape} {fname} centers, "
                          f"{what}: {ms:.4f} ms per call at 20 calls per "
                          f"replay", flush=True)


def lookup_bwd(dev, gen, flush) -> None:
    b, h, w = 8, 80, 180
    w2s = [w // 2 ** i for i in range(chip_smoke.LEVELS)]
    k = 2 * chip_smoke.RADIUS + 1
    c = (torch.rand((b, h, w), generator=gen) * (w + 20) - 10).to(dev)
    g = torch.randn((b, h, w, chip_smoke.LEVELS * k), generator=gen).to(dev)
    runs = {"the kernel": _build.load("corr_lookup"),
            "zeros only (no window lookups)": variant(
                "lookup_bwd_zeros", "corr_lookup",
                [("const int j0 = b - s_base[q];", "const int j0 = -99;"),
                 ("const int j = b - s_base[q];", "const int j = -99;")]),
            "no stores": variant(
                "lookup_bwd_no_stores", "corr_lookup",
                [("      store_run(dst, v);",
                  "      if (v[0] == 12345.f) store_run(dst, v);")])}
    for what, lib in runs.items():
        fn = getattr(lib, "raft_corr_lookup_bwd")
        fn.argtypes, fn.restype = corr_lookup._ARGTYPES, ctypes.c_int

        def call():
            dv = [torch.empty((b, h, w, w2), device=dev) for w2 in w2s]
            _build.check(fn((ctypes.c_void_p * len(w2s))(
                *[v.data_ptr() for v in dv]), (ctypes.c_int * len(w2s))(
                *w2s), len(w2s), c.data_ptr(), g.data_ptr(), b * h * w,
                chip_smoke.RADIUS, torch.cuda.current_stream().cuda_stream),
                what)
            return dv

        print(f"lookup backward fp32 (8,80,180), {what}: "
              f"{chip_smoke.graph_ms(call, flush):.4f} ms by graph replay",
              flush=True)
    n = b * h * w * sum(w2s)
    print(f"torch.zeros of its {n * 4 / 1e6:.1f} MB of dV: "
          f"{chip_smoke.graph_ms(lambda: torch.zeros(n, device=dev), flush):.4f}"
          f" ms by graph replay")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", choices=("alt", "lookup-bwd", "all"),
                    default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: these are measurements of the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    flush = torch.empty(64 * 2 ** 20 // 4, device=dev)
    if args.what in ("alt", "all"):
        alt(dev, gen, flush)
    if args.what in ("lookup-bwd", "all"):
        lookup_bwd(dev, gen, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
