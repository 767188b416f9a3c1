"""Distributed all-to-all: hash/range/random shuffle over runtime tasks.

The analog of the reference's all-to-all execution
(python/ray/data/_internal/execution/operators/hash_shuffle.py and
planner/exchange/*: map tasks partition each input block, reduce tasks
merge one partition each). Blocks move through the shared-memory object
plane — the driver only ever holds block *refs* plus the single block it
is currently streaming to the consumer, never the whole dataset.

Phases:
  1. collect: stream input blocks into the object store (one at a time).
  2. (sort only) sample: each block contributes a key sample; the driver
     computes range boundaries from the union of samples.
  3. map: one `_partition` task per input block -> n_out sub-blocks.
  4. reduce: one `_merge` task per output partition; intermediate refs are
     freed as soon as their partition is reduced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import (Block, block_concat, block_num_rows,
                                block_slice, block_take, object_array)

# Partitions per shuffle: bounded so n_in x n_out ref fan-out stays sane.
MAX_PARTITIONS = 64


def _spec_partition(block: Block, n_out: int, spec: dict) -> List[Block]:
    """Split one block into n_out sub-blocks per the shuffle spec. Runs
    inside a worker task."""
    total = block_num_rows(block)
    mode = spec["mode"]
    if mode == "shuffle":
        rng = np.random.default_rng(spec.get("seed"))
        part = rng.integers(0, n_out, size=total)
    elif mode == "hash":
        key = np.asarray(block[spec["key"]])
        if key.dtype.kind in "OUS":
            # Stable cross-process hash: Python's hash() is salted per
            # process, which would scatter one key across partitions.
            import zlib
            part = np.asarray(
                [zlib.crc32(str(k).encode()) % n_out for k in key],
                dtype=np.int64)
        else:
            part = (key.astype(np.int64, copy=False) % n_out + n_out) % n_out
    elif mode == "range":
        key = np.asarray(block[spec["key"]])
        part = np.searchsorted(spec["bounds"], key, side="right")
    elif mode == "split":
        per = max(1, -(-total // n_out))
        part = np.minimum(np.arange(total) // per, n_out - 1)
    else:
        raise ValueError(mode)
    out = []
    for j in range(n_out):
        idx = np.nonzero(part == j)[0]
        # empty partitions keep their COLUMNS (zero-row block): the join
        # needs the right-side schema in right-empty partitions
        out.append(block_take(block, idx))
    # num_returns=1 stores the return value as ONE object — return the
    # bare block so the merge task doesn't see a single-element list.
    return out[0] if n_out == 1 else out


def _spec_merge(spec: dict, *parts: Block) -> Block:
    """Merge one partition's sub-blocks into a final block. Runs inside a
    worker task."""
    parts = [p for p in parts if block_num_rows(p)]
    if not parts:
        return {}
    merged = block_concat(list(parts))
    mode = spec["mode"]
    if mode == "shuffle":
        rng = np.random.default_rng(spec.get("seed"))
        return block_take(merged, rng.permutation(block_num_rows(merged)))
    if mode == "range":
        idx = np.argsort(merged[spec["key"]], kind="stable")
        return block_take(merged, idx)
    if mode == "hash" and spec.get("aggs"):
        return _aggregate(merged, spec["key"], spec["aggs"])
    return merged


def _aggregate(block: Block, key: str,
               aggs: Dict[str, Tuple[str, Callable]]) -> Block:
    keys = np.asarray(block[key])
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq, starts = np.unique(keys_sorted, return_index=True)
    out_rows: Dict[str, list] = {key: list(uniq)}
    for out_name in aggs:
        out_rows[out_name] = []
    bounds = list(starts) + [len(keys_sorted)]
    for g in range(len(uniq)):
        sel = order[bounds[g]:bounds[g + 1]]
        for out_name, (col, fn) in aggs.items():
            out_rows[out_name].append(fn(np.asarray(block[col])[sel]))
    return {k: np.asarray(v) for k, v in out_rows.items()}


def distributed_all2all(stream: Iterator[Block],
                        spec: dict,
                        n_out: Optional[int] = None) -> Iterator[Block]:
    """Run the shuffle across the cluster; yields output blocks one at a
    time (cites reference shape: hash_shuffle.py HashShuffleOperator)."""
    import ray_tpu_torch

    in_refs = []
    for b in stream:
        if block_num_rows(b):
            in_refs.append(ray_tpu_torch.put(b))
    if not in_refs:
        return
    if n_out is None:
        n_out = min(max(1, len(in_refs)), MAX_PARTITIONS)

    if spec["mode"] == "range":
        spec = dict(spec)
        spec["bounds"] = _sample_bounds(in_refs, spec, n_out)

    cols = _fan_cols(in_refs, n_out, spec)
    merge_fn = ray_tpu_torch.remote(_spec_merge)
    out_refs = [merge_fn.remote(spec, *col) for col in cols]
    # Stream the reduced partitions; free inputs after the first merge
    # lands (all maps have resolved their args by then) and each
    # partition's intermediates as soon as it is consumed.
    first = True
    descending = spec.get("descending", False)
    order = range(n_out - 1, -1, -1) if descending else range(n_out)
    for j in order:
        out = ray_tpu_torch.get(out_refs[j], timeout=600)
        # get() returns zero-copy views into the shared store; copy before
        # freeing or the arena range gets recycled under the caller.
        out = {k: np.array(v) for k, v in out.items()}
        if first:
            ray_tpu_torch.free(in_refs)
            first = False
        ray_tpu_torch.free(cols[j] + [out_refs[j]])
        if block_num_rows(out):
            if descending:
                out = block_take(
                    out, np.arange(block_num_rows(out) - 1, -1, -1))
            yield out


def _fan_cols(in_refs, n_out: int, spec: dict):
    """Map phase: one _spec_partition task per input block; returns the
    transposed [partition][input] ref grid (shared by shuffle and join —
    the free/zero-copy protocol must stay identical in both)."""
    import ray_tpu_torch
    part_fn = ray_tpu_torch.remote(_spec_partition).options(num_returns=n_out)
    rows = []
    for ref in in_refs:
        r = part_fn.remote(ref, n_out, spec)
        rows.append([r] if n_out == 1 else r)  # bare ref when 1 return
    return [[rows[i][j] for i in range(len(rows))] for j in range(n_out)]


def _sample_bounds(in_refs, spec: dict, n_out: int) -> np.ndarray:
    """Range-partition boundaries from per-block samples (reference:
    planner/exchange/sort_task_spec.py SortTaskSpec.sample_boundaries)."""
    import ray_tpu_torch

    key = spec["key"]

    def _sample(block, k=64):
        vals = np.asarray(block[key])
        if len(vals) > k:
            idx = np.random.default_rng(0).choice(
                len(vals), size=k, replace=False)
            vals = vals[idx]
        return vals

    sample_fn = ray_tpu_torch.remote(_sample)
    samples = ray_tpu_torch.get([sample_fn.remote(r) for r in in_refs],
                          timeout=300)
    allv = np.sort(np.concatenate([s for s in samples if len(s)]))
    # n_out == 1 needs NO boundaries — np.clip([]) yields a FLOAT empty
    # array that then faults as an index
    if n_out <= 1:
        return allv[:0]
    qs = np.asarray(
        [int(len(allv) * (j + 1) / n_out) for j in range(n_out - 1)],
        dtype=np.int64)
    return allv[np.clip(qs, 0, len(allv) - 1)]


def distributed_groupby(stream: Iterator[Block], key: str,
                        aggs: Dict[str, Tuple[str, Callable]]
                        ) -> Iterator[Block]:
    """Hash-partition by key, aggregate per partition (all rows of one key
    land in one partition, so per-partition aggregation is exact)."""
    spec = {"mode": "hash", "key": key, "aggs": aggs}
    yield from distributed_all2all(stream, spec)


# --- join ------------------------------------------------------------------
# Reference: python/ray/data/_internal/execution/operators/join.py (hash
# join: both sides hash-partitioned by key, each output partition joined
# independently — all rows of one key land in the same partition pair).

def join_blocks(lb: Optional[Block], rb: Optional[Block], key: str,
                join_type: str, suffix: str) -> Block:
    """Join two (already co-partitioned) blocks on `key`. inner / left;
    left-join fills missing right numerics with NaN and everything else
    with None (object dtype). NOTE: when any left row is unmatched, right
    int/uint/bool columns are promoted to float64 so NaN can represent
    the nulls (numpy has no nullable ints) — same promotion pandas
    applies on a left merge."""
    if lb is None or not block_num_rows(lb):
        return {}
    # a right block with columns but zero rows still contributes SCHEMA:
    # a left join must emit its columns (as nulls) in every partition
    have_right = rb is not None and len(rb) > 0
    r_rows = block_num_rows(rb) if have_right else 0
    keys_l = np.asarray(lb[key])
    ridx: Dict[Any, List[int]] = {}
    if r_rows:
        for i, k in enumerate(np.asarray(rb[key]).tolist()):
            ridx.setdefault(k, []).append(i)
    li: List[int] = []
    ri: List[int] = []
    for i, k in enumerate(keys_l.tolist()):
        matches = ridx.get(k)
        if matches:
            for j in matches:
                li.append(i)
                ri.append(j)
        elif join_type == "left":
            li.append(i)
            ri.append(-1)           # null marker
    if not li:
        return {}
    out = dict(block_take(lb, np.asarray(li, np.int64)))
    if have_right:
        rtake = np.asarray([j if j >= 0 else 0 for j in ri], np.int64)
        nulls = np.asarray([j < 0 for j in ri])
        for col, vals in rb.items():
            if col == key:
                continue
            name = col
            while name in out:   # keep suffixing until unique — a right
                name += suffix   # column named f"{col}{suffix}" must not
                                 # be silently overwritten
            if r_rows:
                v = np.asarray(block_take({col: vals}, rtake)[col])
                if nulls.any():
                    if v.dtype.kind in "fiub" and v.ndim == 1:
                        v = v.astype(np.float64)
                        v[nulls] = np.nan
                    else:
                        # strings, object/ragged AND multi-dim tensor
                        # columns: numpy cannot represent a missing
                        # row densely — demote to object rows with
                        # None (np.resize would silently FLATTEN a
                        # [n,d] tensor column across rows)
                        v = object_array(list(v))
                        v[nulls] = None
            else:  # zero-row right partition: every match is null
                proto = np.asarray(vals)
                if proto.dtype.kind in "fiub" and proto.ndim == 1:
                    v = np.full(len(li), np.nan)
                else:
                    v = np.empty(len(li), dtype=object)   # all None
            out[name] = v
    return out


def _join_partition(key: str, join_type: str, suffix: str, n_left: int,
                    r_schema: Optional[Dict[str, Any]],
                    *parts: Block) -> Block:
    """One output partition: concat this partition's left and right
    sub-blocks, join them. Runs inside a worker task. `r_schema`
    ({col: (dtype, ndim)}) is the right side's schema, threaded through
    so a left join emits the right columns (as nulls) even in
    partitions — or whole joins — where the right side has no rows at
    all. ndim matters: a 2-D tensor column's nulls must be None (object
    rows), not NaN, and a zero-row 1-D reconstruction would lose
    that."""
    left = [p for p in parts[:n_left] if block_num_rows(p)]
    # keep zero-row right parts: they carry the right-side SCHEMA, which
    # a left join needs to emit null columns in right-empty partitions
    right = [p for p in parts[n_left:] if len(p) > 0]
    nonempty_r = [p for p in right if block_num_rows(p)]
    lb = block_concat(left) if left else None
    rb = block_concat(nonempty_r) if nonempty_r else (
        right[0] if right else None)
    if rb is None and r_schema:
        rb = {c: np.empty((0,) * max(nd, 1), dtype=dt)
              for c, (dt, nd) in r_schema.items()}
    return join_blocks(lb, rb, key, join_type, suffix)


def distributed_join(left: Iterator[Block], right: Iterator[Block],
                     key: str, join_type: str = "inner",
                     suffix: str = "_r") -> Iterator[Block]:
    """Hash join across the cluster: both sides partitioned by key, one
    join task per partition, outputs streamed."""
    import ray_tpu_torch

    l_refs = [ray_tpu_torch.put(b) for b in left if block_num_rows(b)]
    r_refs = []
    r_schema = None   # first right block's {col: (dtype, ndim)}
    for b in right:
        if r_schema is None and len(b) > 0:
            r_schema = {c: (np.asarray(v).dtype, np.asarray(v).ndim)
                        for c, v in b.items()}
        if block_num_rows(b):
            r_refs.append(ray_tpu_torch.put(b))
    if not l_refs:
        ray_tpu_torch.free(r_refs)   # nothing to join; don't pin the right side
        return
    n_out = min(max(1, len(l_refs) + len(r_refs)), MAX_PARTITIONS)
    spec = {"mode": "hash", "key": key}
    l_cols = _fan_cols(l_refs, n_out, spec)
    r_cols = _fan_cols(r_refs, n_out, spec) if r_refs \
        else [[] for _ in range(n_out)]
    join_fn = ray_tpu_torch.remote(_join_partition)
    out_refs = []
    cols = []
    for j in range(n_out):
        cols.append(l_cols[j] + r_cols[j])
        out_refs.append(join_fn.remote(key, join_type, suffix,
                                       len(l_cols[j]), r_schema,
                                       *cols[-1]))
    first = True
    for j in range(n_out):
        out = ray_tpu_torch.get(out_refs[j], timeout=600)
        out = {k: np.array(v) for k, v in out.items()}
        if first:
            ray_tpu_torch.free(l_refs + r_refs)
            first = False
        ray_tpu_torch.free(cols[j] + [out_refs[j]])
        if block_num_rows(out):
            yield out
