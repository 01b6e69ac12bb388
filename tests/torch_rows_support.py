"""Shared helpers of the context-parallel CPU tests."""

import numpy as np


def grad_gaps(got, want):
    """Leaf by leaf, |got - want| over the leaf's own gradient scale: the
    worst 99th percentile and the worst element over the leaves whose
    scale is at least 1e-3 of the largest, and how many were skipped
    (the biases before an instance norm, whose true gradient is zero).
    The scheme of the JAX package's tests/test_rows_gru.py: an untrained
    instance-norm net's gradients reassociate at the percent level, while
    a lost halo row's gradient or a mis-reduced exchange moves most
    entries by whole factors."""
    top = max(float(w.abs().max()) for w in want.values())
    q99 = worst = 0.0
    skipped = 0
    for k, w in want.items():
        scale = float(w.abs().max())
        if scale < 1e-3 * top:
            skipped += 1
            continue
        rel = (got[k] - w).abs().numpy().ravel() / scale
        q99 = max(q99, float(np.quantile(rel, 0.99)))
        worst = max(worst, float(rel.max()))
    return q99, worst, skipped
