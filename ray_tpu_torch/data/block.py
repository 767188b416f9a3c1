"""Blocks: the unit of data movement — columnar numpy tables.

Reference: python/ray/data/block.py (blocks are Arrow tables there). Here a
block is a dict[str, np.ndarray] — numpy-native so batches flow zero-copy
into torch.from_numpy (and from there onto the card); Arrow interop at
the parquet boundary only.

Column dtype contract:
- uniform scalars / equal-shape sequences -> dense numeric arrays (2D+
  for tensor columns): the ZERO-COPY tensor path into torch.from_numpy.
- strings -> native numpy 'U' arrays (vectorized sort/compare).
- RAGGED sequences (per-row variable shape: token lists, boxes, dicts)
  -> an explicit 1-D object array holding the Python values. Row
  identity is preserved through slice/take/concat — shuffle, sort,
  groupby and join all work — but the column rides the OBJECT path:
  no vectorized kernels, no zero-copy into torch. Pad/truncate to a
  fixed shape (e.g. map_batches) before feeding device code.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def block_from_rows(rows: List[dict]) -> Block:
    if not rows:
        return {}
    cols: Dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r.get(k))
    return {k: _to_array(v) for k, v in cols.items()}


def _to_array(values: list) -> np.ndarray:
    try:
        return np.asarray(values)
    except ValueError:
        # Ragged rows (inhomogeneous shapes raise under numpy>=1.24):
        # keep the column honest as a 1-D object array of the original
        # Python values instead of crashing the pipeline — see the
        # module docstring's dtype contract.
        return object_array(values)


def object_array(values: list) -> np.ndarray:
    """1-D object array with one slot per ROW (np.empty + per-row
    assignment: a plain fill can still trip numpy's broadcasting when
    rows happen to share a length)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def block_from_items(items: List[Any]) -> Block:
    """Non-dict items get the reference's implicit 'item' column
    (reference: from_items wraps scalars the same way)."""
    if items and isinstance(items[0], dict):
        return block_from_rows(items)
    return {"item": _to_array(items)}


def block_num_rows(b: Block) -> int:
    for v in b.values():
        return len(v)
    return 0


def block_slice(b: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in b.items()}


def block_take(b: Block, idx: np.ndarray) -> Block:
    return {k: v[idx] for k, v in b.items()}


def block_concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    out: Block = {}
    for k in blocks[0].keys():
        parts = [b[k] for b in blocks]
        try:
            out[k] = np.concatenate(parts)
        except ValueError:
            # a column ragged ACROSS blocks (dense [n,3] in one part,
            # [m,4] or object in another): fall back to one object row
            # per element. Dense parts convert via tolist() so the
            # column holds plain Python values THROUGHOUT — mixing
            # ndarray rows with list rows would make `row == [...]`
            # comparisons blow up for some rows only.
            rows = []
            for p in parts:
                rows.extend(list(p) if p.dtype == object else p.tolist())
            out[k] = object_array(rows)
    return out


def block_rows(b: Block) -> Iterable[dict]:
    n = block_num_rows(b)
    keys = list(b.keys())
    for i in range(n):
        yield {k: b[k][i] for k in keys}


def block_to_pandas(b: Block):
    import pandas as pd
    return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                         for k, v in b.items()})


def block_from_arrow(table) -> Block:
    out = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            out[name] = col.to_numpy(zero_copy_only=False)
        except Exception:
            out[name] = np.asarray(col.to_pylist(), dtype=object)
    return out


def block_to_arrow(b: Block):
    import pyarrow as pa
    return pa.table({k: pa.array(list(v) if v.ndim > 1 else v)
                     for k, v in b.items()})
