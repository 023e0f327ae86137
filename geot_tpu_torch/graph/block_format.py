"""Windowed dense-block format with column deduplication, host side.

Port of `geot_tpu/graph/block_format.py` (numpy only, copied so the port
imports nothing of the JAX package): rows are grouped into windows, each
window's nonzero columns are deduplicated and padded to a multiple of
`wide`, and its values become a dense [window, padded_cols] block
addressed by window-local column ids (the FlashSparse-style format of
GeoT's `csr_to_block_format`). No kernel of the port consumes the blocks:
the format is kept for parity and for its dedup diagnostics
(`block_stats`; `graph.stream_plan.cell_census` is the statistic the
stream path decides by).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["BlockFormat", "csr_to_block_format", "block_stats"]


@dataclasses.dataclass
class BlockFormat:
    """window windows of `window_rows` rows each (last one ragged).

    win_ptr:   [n_win+1] — window w's deduped (padded) columns live at
               col_ids[win_ptr[w]:win_ptr[w+1]]; each extent is a multiple
               of `wide`. Padding entries repeat the window's last real
               column (reference pads likewise rather than with sentinels).
    col_ids:   [total_cols] — global column id per window-local slot.
    col_local: [nnz] — window-local column slot of each nonzero.
    values:    [nnz] or None — nonzero values in CSR order (unchanged).
    """

    window_rows: int
    wide: int
    num_rows: int
    num_cols: int
    win_ptr: np.ndarray
    col_ids: np.ndarray
    col_local: np.ndarray
    values: Optional[np.ndarray]

    @property
    def n_windows(self) -> int:
        return len(self.win_ptr) - 1

    def dense_block(self, w: int, indptr: np.ndarray, col: np.ndarray) -> np.ndarray:
        """Materialize window w as a dense [rows_in_window, padded_cols]
        value block (testing/inspection)."""
        r0 = w * self.window_rows
        r1 = min(r0 + self.window_rows, self.num_rows)
        width = self.win_ptr[w + 1] - self.win_ptr[w]
        blk = np.zeros((r1 - r0, width), np.float32)
        for r in range(r0, r1):
            for e in range(indptr[r], indptr[r + 1]):
                v = 1.0 if self.values is None else self.values[e]
                blk[r - r0, self.col_local[e]] += v
        return blk


def csr_to_block_format(
    indptr: np.ndarray,
    col: np.ndarray,
    values: Optional[np.ndarray] = None,
    *,
    window_rows: int = 8,
    wide: int = 16,
) -> BlockFormat:
    """Build the dedup block format from CSR (reference
    `csr_to_block_format`, `geot/format_preprocess.py:7-129`)."""
    indptr = np.asarray(indptr)
    col = np.asarray(col)
    num_rows = len(indptr) - 1
    n_win = max(-(-num_rows // window_rows), 1)
    win_ptr = np.zeros(n_win + 1, np.int64)
    col_ids_parts = []
    col_local = np.zeros(len(col), np.int32)
    for w in range(n_win):
        r0, r1 = w * window_rows, min((w + 1) * window_rows, num_rows)
        e0, e1 = indptr[r0], indptr[r1]
        wcols = col[e0:e1]
        uniq, inv = np.unique(wcols, return_inverse=True)
        if len(uniq) == 0:
            uniq = np.zeros(0, col.dtype)
        pad_to = max(-(-max(len(uniq), 1) // wide) * wide, wide)
        padded = np.empty(pad_to, col.dtype)
        padded[: len(uniq)] = uniq
        padded[len(uniq) :] = uniq[-1] if len(uniq) else 0
        col_ids_parts.append(padded)
        col_local[e0:e1] = inv.astype(np.int32)
        win_ptr[w + 1] = win_ptr[w] + pad_to
    return BlockFormat(
        window_rows=window_rows,
        wide=wide,
        num_rows=num_rows,
        num_cols=int(col.max()) + 1 if len(col) else 0,
        win_ptr=win_ptr,
        col_ids=np.concatenate(col_ids_parts) if col_ids_parts else np.zeros(0, col.dtype),
        col_local=col_local,
        values=None if values is None else np.asarray(values),
    )


def block_stats(bf: BlockFormat, nnz: int) -> dict:
    """Dedup/padding diagnostics: `dedup_ratio` = nnz / real unique cols
    (gather-traffic saving bound), `pad_overhead` = padded/real cols."""
    total_padded = int(bf.win_ptr[-1])
    return dict(
        n_windows=bf.n_windows,
        total_padded_cols=total_padded,
        cols_per_window=total_padded / max(bf.n_windows, 1),
        dedup_ratio=nnz / max(total_padded, 1),
    )
