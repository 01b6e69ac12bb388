#!/usr/bin/env python3
"""Context parallelism of the PyTorch port across the cards of one host.

    python3 tools/torch_cp_cards.py [--iters 4] [--hw 1984 2880]

One process drives a device group made of distinct cards (``cuda:0`` ..
``cuda:n-1``, ``parallel/mesh.make_mesh``), the model's parameters on
``cuda:0``.  For every group the host's cards can supply, with the
default config at full width (seeded random weights), fp32:

* a ``rows_shards=n, rows_gru=True`` pair of ``--hw`` (padded to a
  multiple of 32) at ``--iters`` iterations, and a ``corr_w2_shards=n``
  pair at KITTI's 375x1242, each against the unsharded model on
  ``cuda:0``: max |flow difference|, seconds, and every card's peak
  ``max_memory_allocated``;
* one default training step (``TrainConfig()``: batch 8, 320x720, 22
  iterations; ``sequence_loss``, forward and backward) under
  ``rows_shards=2, rows_gru`` and under ``corr_w2_shards=n``: the loss,
  the worst per-leaf 99th percentile of the gradients' difference over
  the leaf's scale, seconds and every card's peak (each step timed after
  one untimed step of the same configuration);
* on four cards, a serving engine with ``xl_mesh="rows=2"`` and
  ``xl_workers=2`` over the cards (groups ``cuda:0+1`` and ``cuda:2+3``,
  each with its own copy of the weights): a KITTI pair dispatched on
  each group and through ``infer``, against ``make_forward`` solo on
  ``cuda:0``.

The unsharded model on weights moved by one fp32 ulp gives the spread
each check is held to: a sharded result passes within the larger of
5e-3 px (flows), 1e-4 (the loss, relative) or 5e-3 (the gradients)
and three times that spread.  Prints the cards (``nvidia-smi``), one JSON line per run
and a last JSON line ``{"ok": ...}``; exits 1 when a check fails and 2
without two cards.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# phase 39's helpers, so that one card and several measure alike
from chip_smoke import grad_gap, padded_pair, release, ulp_moved  # noqa: E402

SEED = 0
ATOL = 5e-3               # px for the flows, per-leaf q99 for gradients
LOSS_RTOL = 1e-4
SPREAD_FACTOR = 3.0
KITTI_HW = (375, 1242)


def measured(fn, cards):
    """``fn()`` with every card's peak reset before: (result, seconds,
    [peak GiB per card])."""
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    out = fn()
    for d in cards:
        torch.cuda.synchronize(d)
    secs = time.perf_counter() - t0
    return out, secs, [round(torch.cuda.max_memory_allocated(d) / 2 ** 30,
                             3) for d in cards]


def host_cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def xl_groups(cfg, state, moved, cards, iters):
    """The xl tier over two groups of two distinct cards: each group's
    program and ``infer`` against ``make_forward`` solo on the first card,
    within the larger of ATOL and SPREAD_FACTOR x the one-ulp spread."""
    from raft_stereo_tpu_torch.eval.runner import make_forward
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.serving import (FAMILY_XL, ServeConfig,
                                               ServingEngine)

    left, right = (np.ascontiguousarray(x[0].cpu().numpy().astype(np.uint8))
                   for x in padded_pair(KITTI_HW, SEED + 39))
    hw = left.shape[:2]
    solo = {}
    for what, sd in (("solo", state), ("ulp", moved)):
        m = RAFTStereo(cfg)
        m.load_state_dict(sd)
        m = m.to(cards[0]).eval()
        with torch.inference_mode():
            solo[what] = make_forward(m, iters)(
                *(torch.from_numpy(a[None]).to(cards[0])
                  for a in (left, right)))[0].cpu().numpy()
        del m
        release()
    bound = max(ATOL, SPREAD_FACTOR * float(
        np.abs(solo["ulp"] - solo["solo"]).max()))
    with ServingEngine(cfg, state, ServeConfig(
            iters=iters, tiers=(), batch_sizes=(1,), max_batch=1,
            xl_mesh="rows=2", xl_workers=2,
            xl_threshold_pixels=hw[0] * hw[1] - 1),
            device="cuda", xl_devices=cards[:4]) as eng:
        groups = [[str(d) for d in g.devices] for g in eng.xl.groups]
        leads = [str(next(g.model.parameters()).device)
                 for g in eng.xl.groups]
        flows, seconds = [], []
        for widx in eng._xl_worker_indices():
            t0 = time.perf_counter()
            out, _ = eng._xl_dispatch(
                widx, (widx, hw, 1, None, FAMILY_XL, None), left[None],
                right[None])
            seconds.append(round(time.perf_counter() - t0, 4))
            flows.append(out[0].reshape(solo["solo"].shape))
        res = eng.infer(left, right, timeout=600)
    gaps = [float(np.abs(f - solo["solo"]).max())
            for f in flows + [res.flow.reshape(solo["solo"].shape)]]
    release()
    return {"run": "xl groups", "cards": 4, "groups": groups,
            "weights_on": leads, "hw": list(hw), "iters": iters,
            "max_abs_px": gaps, "bound": bound,
            "first_dispatch_seconds": seconds, "tier": res.tier,
            "mesh": res.mesh,
            "ok": (groups == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
                   and leads == ["cuda:0", "cuda:2"] and res.tier == "xl"
                   and max(gaps) <= bound)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4)
    # phase 37's 1988x2880 pair cut to 1984 rows, whose fine level splits
    # into four slabs of a multiple of 4 rows
    ap.add_argument("--hw", type=int, nargs=2, default=(1984, 2880))
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs a host with two CUDA cards or more", file=sys.stderr)
        return 2
    from raft_stereo_tpu_torch.config import RaftStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.data.synthetic import SyntheticStereoLoader
    from raft_stereo_tpu_torch.eval.runner import full_fp32
    from raft_stereo_tpu_torch.kernels import _build
    from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
    from raft_stereo_tpu_torch.parallel.mesh import make_mesh, mesh_contexts
    from raft_stereo_tpu_torch.training.loss import sequence_loss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    full_fp32()
    _build.build_all()
    cards = host_cards()
    n_cards = len(cards)
    lead = cards[0]
    cfg = RaftStereoConfig()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        state = RAFTStereo(cfg).state_dict()
    moved = ulp_moved(state, SEED + 1)
    sizes = [n for n in (2, 4) if n <= n_cards]
    ok = True

    def model_of(sd, **kw):
        m = RAFTStereo(dataclasses.replace(cfg, **kw))
        m.load_state_dict(sd)
        return m.to(lead)

    def contexts(kw, n):
        if not kw:
            return contextlib.nullcontext()
        return mesh_contexts(make_mesh(
            n_rows=kw.get("rows_shards", 1),
            n_corr=kw.get("corr_w2_shards", 1), devices=cards[:n]))

    def report(rec):
        nonlocal ok
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)

    # the pairs
    for axis, hw in (("rows", tuple(args.hw)), ("corr", KITTI_HW)):
        img1, img2 = padded_pair(hw, SEED + 39)
        base = {}
        for what, sd in (("solo", state), ("ulp", moved)):
            m = model_of(sd).eval()
            with torch.inference_mode():
                m(img1, img2, iters=1)
                base[what] = measured(lambda: m(img1, img2,
                                                iters=args.iters)[1], cards)
            del m
            release()
        spread = float((base["ulp"][0] - base["solo"][0]).abs().max())
        bound = max(ATOL, SPREAD_FACTOR * spread)
        for n in sizes:
            kw = (dict(rows_shards=n, rows_gru=True) if axis == "rows"
                  else dict(corr_w2_shards=n))
            m = model_of(state, **kw).eval()
            try:
                with torch.inference_mode(), contexts(kw, n):
                    m(img1, img2, iters=1)
                    flow, secs, peaks = measured(
                        lambda: m(img1, img2, iters=args.iters)[1], cards)
                d = float((flow.to(lead) - base["solo"][0]).abs().max())
                rec = {"run": f"{axis} pair", "cards": n,
                       "hw": list(img1.shape[1:3]), "iters": args.iters,
                       "max_abs_px": d, "spread_px": spread, "bound": bound,
                       "seconds": round(secs, 4),
                       "solo_seconds": round(base["solo"][1], 4),
                       "peak_gib": peaks, "solo_peak_gib": base["solo"][2],
                       "ok": bool(torch.isfinite(flow).all()) and d <= bound}
            except ValueError as e:      # a geometry the group refuses
                rec = {"run": f"{axis} pair", "cards": n, "refused": str(e),
                       "ok": True}
            report(rec)
            del m
            release()
        del img1, img2, base
        release()

    # the training steps
    tc = TrainConfig()
    host = SyntheticStereoLoader(tc.batch_size, tc.image_size,
                                 seed=SEED).batch(0)
    batch = {k: torch.as_tensor(v).to(lead) for k, v in host.items()}

    def step(m, kw, n):
        def run():
            m.zero_grad(set_to_none=True)
            with contexts(kw, n):
                preds = m(batch["image1"], batch["image2"],
                          iters=tc.train_iters, test_mode=False)
                loss = sequence_loss(preds, batch["flow"].float(),
                                     batch["valid"].float(),
                                     loss_gamma=tc.loss_gamma,
                                     max_flow=tc.max_flow)[0]
                loss.backward()
            return float(loss.detach())

        run()        # warm-up: cuDNN's choice of algorithms, first allocations
        loss, secs, peaks = measured(run, cards)
        grads = {k: p.grad.detach().clone() for k, p in m.named_parameters()
                 if p.grad is not None}
        return loss, grads, secs, peaks

    ref = {}
    for what, sd in (("solo", state), ("ulp", moved)):
        m = model_of(sd).train()
        ref[what] = step(m, {}, 1)
        del m
        release()
    loss_spread = abs(ref["ulp"][0] - ref["solo"][0]) / abs(ref["solo"][0])
    grad_spread = grad_gap(ref["ulp"][1], ref["solo"][1])
    loss_bound = max(LOSS_RTOL, SPREAD_FACTOR * loss_spread)
    grad_bound = max(ATOL, SPREAD_FACTOR * grad_spread)
    for kw, n in ((dict(rows_shards=2, rows_gru=True), 2),
                  *((dict(corr_w2_shards=n), n) for n in sizes)):
        m = model_of(state, **kw).train()
        loss, grads, secs, peaks = step(m, kw, n)
        rel = abs(loss - ref["solo"][0]) / abs(ref["solo"][0])
        gap = grad_gap(grads, ref["solo"][1])
        report({"run": "rows step" if "rows_shards" in kw else "corr step",
                "cards": n, "loss": loss, "solo_loss": ref["solo"][0],
                "loss_rel": rel, "loss_bound": loss_bound, "grad_q99": gap,
                "grad_bound": grad_bound, "seconds": round(secs, 4),
                "solo_seconds": round(ref["solo"][2], 4), "peak_gib": peaks,
                "solo_peak_gib": ref["solo"][3],
                "ok": rel <= loss_bound and gap <= grad_bound})
        del m, grads
        release()
    if n_cards >= 4:
        report(xl_groups(cfg, state, moved, cards, args.iters))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
