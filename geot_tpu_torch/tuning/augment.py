"""Index-distribution augmentation for tuning-table training data.

A numpy copy of `geot_tpu/tuning/augment.py`. Parity with the reference's
dataset augmentation (`data/augment_dataset.py`: per source graph, 5 noise
augmentations — random index jitter + re-sort — and 12 scale augmentations
— up/down-resampling of the sorted index by powers of two). These generate
the families of sorted-index shapes the sweep
(`geot_tpu_torch.tuning.sweep`) measures so the lookup table generalizes
beyond the exact benchmark graphs.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["noise_augment", "scale_augment", "augment_sorted_index"]


def noise_augment(
    index_sorted: np.ndarray, n_variants: int = 5, frac: float = 0.05, seed: int = 0
) -> List[np.ndarray]:
    """Jitter a fraction of entries uniformly and re-sort (reference
    `augment_dataset.py:211-220`)."""
    rng = np.random.default_rng(seed)
    n = len(index_sorted)
    hi = int(index_sorted[-1]) + 1 if n else 1
    out = []
    for _ in range(n_variants):
        idx = index_sorted.copy()
        k = max(int(frac * n), 1)
        pos = rng.integers(0, n, k)
        idx[pos] = rng.integers(0, hi, k)
        idx.sort()
        out.append(idx)
    return out


def scale_augment(
    index_sorted: np.ndarray, scales: Tuple[float, ...] = (0.25, 0.5, 2.0, 4.0)
) -> List[np.ndarray]:
    """Resample the sorted index to scaled lengths, preserving the segment-
    size distribution (reference `augment_dataset.py:199-247` uses
    F.interpolate; linear resampling of the sorted sequence is the same
    operation on a monotone signal)."""
    n = len(index_sorted)
    out = []
    for s in scales:
        m = max(int(n * s), 1)
        src_pos = np.linspace(0, n - 1, m)
        idx = index_sorted[np.round(src_pos).astype(np.int64)]
        out.append(np.sort(idx))
    return out


def augment_sorted_index(
    index_sorted: np.ndarray, *, seed: int = 0
) -> Iterator[Tuple[str, np.ndarray]]:
    """All augmentations of one sorted index, tagged (reference writes
    `idx_data/{name}_idx_{n}_{i}.npy`; here they stream to the sweep)."""
    for i, idx in enumerate(noise_augment(index_sorted, seed=seed)):
        yield f"noise{i}", idx
    for i, idx in enumerate(scale_augment(index_sorted)):
        yield f"scale{i}", idx
