"""Dataset: lazy logical plan → streaming block execution.

Reference: python/ray/data/dataset.py:189 (Dataset), the logical plan +
rule-based optimizer (data/_internal/logical/), physical operators
(data/_internal/execution/operators/) and the StreamingExecutor
(streaming_executor.py:76). Here the plan is a chain of operators executed
as a generator pipeline — block-at-a-time streaming with implicit
backpressure (a consumer pulls, producers run) — with per-stage fan-out to
runtime tasks for CPU-heavy map_batches (reference: ActorPoolMapOperator /
TaskPoolMapOperator).

Shuffle-like ops (sort/groupby/random_shuffle/repartition) are pipeline
breakers that materialize, matching the reference's all-to-all operators.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np

from ray_tpu_torch.data.block import (Block, block_concat, block_from_items,
                                block_from_rows, block_num_rows, block_rows,
                                block_slice, block_take, block_to_pandas)

BatchFormat = str  # "numpy" (dict of arrays) | "pandas" | "rows"


# --- logical operators -------------------------------------------------------

@dataclass
class _Op:
    name: str
    kind: str                      # source|map|filter|flat|all2all|...
    fn: Optional[Callable] = None
    args: dict = field(default_factory=dict)


class Dataset:
    """Lazy, immutable; every transform returns a new Dataset with one more
    operator on the plan (reference: dataset.py Dataset._plan)."""

    def __init__(self, ops: List[_Op]):
        self._ops = ops

    # ---- plan construction ----
    def _with(self, op: _Op) -> "Dataset":
        return Dataset(self._ops + [op])

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with(_Op("map", "map_rows", fn))

    def map_batches(self, fn: Callable, *,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    num_cpus: Optional[float] = None,
                    max_in_flight_bytes: Optional[int] = None,
                    batch_size: Optional[int] = 4096,
                    batch_format: BatchFormat = "numpy",
                    concurrency: Optional[int] = None) -> "Dataset":
        """``fn`` may be a FUNCTION (stateless: runs inline, or as a
        task pool with `concurrency`) or a callable CLASS (stateful —
        e.g. a model loaded once per worker: runs on an ACTOR POOL of
        `concurrency` actors, constructed with fn_constructor_args;
        reference: ActorPoolMapOperator / ActorPoolStrategy).
        ``max_in_flight_bytes`` bounds the bytes of input batches
        concurrently in flight — fan-out stages otherwise have no
        memory ceiling (reference:
        data/_internal/execution/backpressure_policy/)."""
        return self._with(_Op("map_batches", "map_batches", fn,
                              {"batch_size": batch_size,
                               "batch_format": batch_format,
                               "concurrency": concurrency,
                               "fn_constructor_args": fn_constructor_args,
                               "fn_constructor_kwargs":
                                   fn_constructor_kwargs or {},
                               "num_cpus": num_cpus,
                               "max_in_flight_bytes":
                                   max_in_flight_bytes}))

    def flat_map(self, fn: Callable[[dict], List[dict]]) -> "Dataset":
        return self._with(_Op("flat_map", "flat_map", fn))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with(_Op("filter", "filter", fn))

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]
                   ) -> "Dataset":
        def add(batch):
            batch = dict(batch)
            batch[name] = fn(batch)
            return batch
        return self.map_batches(add, batch_size=None)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}
        return self.map_batches(drop, batch_size=None)

    def select_columns(self, cols: List[str]) -> "Dataset":
        # A declarative op (not a map_batches closure) so the optimizer
        # can push the projection into a parquet scan.
        return self._with(_Op("select", "select", None,
                              {"cols": list(cols)}))

    def limit(self, n: int) -> "Dataset":
        return self._with(_Op("limit", "limit", None, {"n": n}))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(_Op("repartition", "all2all", None,
                              {"mode": "repartition", "n": num_blocks}))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(_Op("random_shuffle", "all2all", None,
                              {"mode": "shuffle", "seed": seed}))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with(_Op("sort", "all2all", None,
                              {"mode": "sort", "key": key,
                               "descending": descending}))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        return self._with(_Op("union", "union", None,
                              {"others": [o._ops for o in others]}))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._with(_Op("zip", "zip", None, {"other": other._ops}))

    def join(self, other: "Dataset", on: str, *,
             join_type: str = "inner", suffix: str = "_r") -> "Dataset":
        """Hash join on a key column (reference:
        data/_internal/execution/operators/join.py). ``join_type`` is
        "inner" or "left"; colliding right columns get ``suffix``. Runs
        distributed when the runtime is up (both sides hash-partitioned
        by key, one join task per partition)."""
        if join_type not in ("inner", "left"):
            raise ValueError("join_type must be 'inner' or 'left'")
        return self._with(_Op("join", "join", None,
                              {"other": other._ops, "on": on,
                               "join_type": join_type, "suffix": suffix}))

    # ---- execution ----
    def iter_blocks(self) -> Iterator[Block]:
        yield from _execute(self._ops)

    def optimized_plan(self) -> List[_Op]:
        """The plan after the rewrite rules run (introspection/tests)."""
        return _optimize(self._ops)

    def materialize(self) -> "Dataset":
        blocks = [b for b in self.iter_blocks() if block_num_rows(b)]
        return Dataset([_Op("from_blocks", "source", None,
                            {"blocks": blocks})])

    # ---- consumption ----
    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def take(self, n: int = 20) -> List[dict]:
        out: List[dict] = []
        for b in self.iter_blocks():
            for r in block_rows(b):
                out.append(r)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[dict]:
        return [r for b in self.iter_blocks() for r in block_rows(b)]

    def take_batch(self, batch_size: int = 20,
                   batch_format: BatchFormat = "numpy"):
        it = self.iterator().iter_batches(batch_size=batch_size,
                                          batch_format=batch_format)
        return next(iter(it))

    def show(self, n: int = 20) -> None:
        for r in self.take(n):
            print(r)

    def schema(self) -> Dict[str, str]:
        for b in self.iter_blocks():
            if block_num_rows(b):
                return {k: str(v.dtype) for k, v in b.items()}
        return {}

    def columns(self) -> List[str]:
        return list(self.schema().keys())

    def to_pandas(self):
        blocks = list(self.iter_blocks())
        return block_to_pandas(block_concat(blocks) if blocks else {})

    def sum(self, on: str) -> float:
        return float(sum(float(np.sum(b[on]))
                         for b in self.iter_blocks() if block_num_rows(b)))

    def min(self, on: str):
        vals = [np.min(b[on]) for b in self.iter_blocks()
                if block_num_rows(b)]
        return np.min(vals) if vals else None

    def max(self, on: str):
        vals = [np.max(b[on]) for b in self.iter_blocks()
                if block_num_rows(b)]
        return np.max(vals) if vals else None

    def mean(self, on: str) -> Optional[float]:
        total, count = 0.0, 0
        for b in self.iter_blocks():
            n = block_num_rows(b)
            if n:
                total += float(np.sum(b[on]))
                count += n
        return total / count if count else None

    def iter_rows(self) -> Iterator[dict]:
        for b in self.iter_blocks():
            yield from block_rows(b)

    def iterator(self) -> "DataIterator":
        from ray_tpu_torch.data.iterator import DataIterator
        return DataIterator(self.iter_blocks)

    def iter_batches(self, **kw):
        return self.iterator().iter_batches(**kw)

    def iter_torch_batches(self, **kw):
        return self.iterator().iter_torch_batches(**kw)

    def iter_device_batches(self, **kw):
        return self.iterator().iter_device_batches(**kw)

    # ---- split for distributed training ----
    def streaming_split(self, n: int, *, equal: bool = True
                        ) -> List["DataIterator"]:
        """n per-worker iterators (reference: dataset.py:2037
        streaming_split + _internal/iterator/stream_split_iterator.py).
        Each shard iterator opens a push-based streaming TASK
        (num_returns="streaming") at iteration time: the producer runs
        the plan on a worker and yields only that shard's row-slices,
        so blocks flow producer -> consumer as they are produced with
        stream-window-bounded memory — no upfront materialization.
        Iterators are picklable (plan payload + shard index), open
        their stream in the CONSUMING process (each train worker owns
        its own stream), and are re-iterable: every epoch submits a
        fresh producer task.

        Unlike the reference's coordinator-actor design, shards execute
        the plan independently (n plan runs instead of one) — the
        tradeoff buys re-iterability and zero idle-actor footprint."""
        from ray_tpu_torch.data.iterator import DataIterator
        import cloudpickle
        payload = cloudpickle.dumps(self._ops, protocol=5)

        def make_iter(idx):
            def gen():
                import ray_tpu_torch as rt
                g = rt.remote(_produce_shard).options(
                    num_returns="streaming").remote(payload, idx, n,
                                                    equal)
                try:
                    for ref in g:
                        b = rt.get(ref)
                        # consumed: free now — multi-epoch re-iteration
                        # mints fresh oids each pass, so unfreed blocks
                        # would accumulate in this worker's store
                        rt.free([ref])
                        yield b
                finally:
                    g.close()  # early exit stops this shard's stream
            return DataIterator(gen)
        return [make_iter(i) for i in range(n)]

    def split(self, n: int) -> List["Dataset"]:
        blocks = list(self.iter_blocks())
        rows = block_concat(blocks) if blocks else {}
        total = block_num_rows(rows)
        per = total // n
        out = []
        for i in range(n):
            start = i * per
            end = total if i == n - 1 else (i + 1) * per
            out.append(Dataset([_Op("from_blocks", "source", None,
                                    {"blocks": [block_slice(rows, start,
                                                            end)]})]))
        return out

    # ---- writes ----
    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_parquet
        write_parquet(self, path)

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_csv
        write_csv(self, path)

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_json
        write_json(self, path)

    def write_tfrecord(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_tfrecord
        write_tfrecord(self, path)

    def __repr__(self):
        names = "->".join(op.name for op in self._ops)
        return f"Dataset({names})"


def _produce_shard(ops_payload: bytes, shard: int, n: int, equal: bool):
    """Streaming-split producer task (sync generator; runs under
    num_returns="streaming"): executes the plan and yields shard
    `shard`'s blocks. equal=True row-slices every block across all
    shards (rotating the remainder rows) so shards stay row-balanced
    without knowing the total row count up front; equal=False deals
    whole blocks round-robin."""
    import cloudpickle
    ops = cloudpickle.loads(ops_payload)
    rr = 0
    for b in Dataset(ops).iter_blocks():
        rows = block_num_rows(b)
        if not rows:
            continue
        if equal:
            per, extra = divmod(rows, n)
            start = 0
            for j in range(n):
                cnt = per + (1 if (j - rr) % n < extra else 0)
                if cnt and j == shard:
                    yield block_slice(b, start, start + cnt)
                start += cnt
            rr = (rr + extra) % n
        else:
            if rr % n == shard:
                yield b
            rr += 1


class GroupedData:
    """Hash aggregation (reference: grouped_data.py + hash-aggregate
    physical operator)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, cols: Dict[str, Tuple[str, Callable]]) -> Dataset:
        if _runtime_up():
            # Hash-partitioned distributed aggregation: every row of a key
            # lands in one partition, aggregated there by a task
            # (reference: hash-aggregate over hash_shuffle.py).
            from ray_tpu_torch.data.shuffle import distributed_groupby
            blocks = list(distributed_groupby(
                self._ds.iter_blocks(), self._key, cols))
            return Dataset([_Op("from_blocks", "source", None,
                                {"blocks": blocks})])
        groups: Dict[Any, List[dict]] = {}
        for row in self._ds.iter_rows():
            groups.setdefault(row[self._key], []).append(row)
        out_rows = []
        for k, rows in groups.items():
            out = {self._key: k}
            for out_name, (col, fn) in cols.items():
                out[out_name] = fn(np.asarray([r[col] for r in rows]))
            out_rows.append(out)
        return Dataset([_Op("from_blocks", "source", None,
                            {"blocks": [block_from_rows(out_rows)]})])

    def count(self) -> Dataset:
        return self._agg({"count()": (self._key, len)})

    def sum(self, on: str) -> Dataset:
        return self._agg({f"sum({on})": (on, lambda v: float(np.sum(v)))})

    def mean(self, on: str) -> Dataset:
        return self._agg({f"mean({on})": (on, lambda v: float(np.mean(v)))})

    def min(self, on: str) -> Dataset:
        return self._agg({f"min({on})": (on, lambda v: np.min(v))})

    def max(self, on: str) -> Dataset:
        return self._agg({f"max({on})": (on, lambda v: np.max(v))})

    def std(self, on: str) -> Dataset:
        return self._agg({f"std({on})": (on, lambda v: float(np.std(v)))})


# --- plan optimizer ----------------------------------------------------------

def _optimize(ops: List[_Op]) -> List[_Op]:
    """Rule-based logical rewrite (reference:
    data/_internal/logical/optimizers.py — there a visitor framework;
    here two high-value rules over the op list):

    1. projection pushdown — select_columns directly after read_parquet
       narrows the scan itself, so parquet reads only those columns
       off disk;
    2. stage fusion — consecutive row-wise ops (map/filter/flat_map)
       collapse into ONE operator that makes a single pass over each
       block instead of materializing an intermediate block per stage.
    """
    ops = list(ops)
    # rule 1: fold consecutive selects into a parquet scan — only when
    # the select NARROWS the current projection (folding a widening
    # select would silently resurrect dropped columns; left unfolded it
    # raises KeyError at execution, the pre-optimizer behavior)
    if ops and ops[0].name == "read_parquet":
        while len(ops) > 1 and ops[1].kind == "select":
            cols = ops[1].args["cols"]
            cur = ops[0].args.get("columns")
            if cur is not None and not set(cols) <= set(cur):
                break
            src_args = dict(ops[0].args)
            src_args["columns"] = list(cols)
            ops[0] = _Op("read_parquet", "source", None, src_args)
            del ops[1]
    # rule 2: fuse adjacent row-wise stages
    fused: List[_Op] = []
    for op in ops:
        if op.kind in ("map_rows", "filter", "flat_map"):
            if fused and fused[-1].kind == "fused_rows":
                prev = fused[-1]
                fused[-1] = _Op(f"{prev.name}+{op.name}", "fused_rows",
                                None, {"stages": prev.args["stages"]
                                       + [(op.kind, op.fn)]})
            else:
                fused.append(_Op(op.name, "fused_rows", None,
                                 {"stages": [(op.kind, op.fn)]}))
        else:
            fused.append(op)
    return fused


# --- execution engine --------------------------------------------------------

def _execute(ops: List[_Op]) -> Iterator[Block]:
    """Build the generator pipeline bottom-up. Each stage pulls from the
    previous — streaming with inherent backpressure (the reference gets the
    same property from StreamingExecutor's bounded buffers)."""
    stream: Iterator[Block] = iter(())
    for op in _optimize(ops):
        stream = _apply(stream, op)
    return stream


def _apply(stream: Iterator[Block], op: _Op) -> Iterator[Block]:
    if op.kind == "source":
        return _source(op)
    if op.kind == "map_rows":
        return (_map_rows(b, op.fn) for b in stream)
    if op.kind == "select":
        cols = op.args["cols"]
        return ({k: b[k] for k in cols} for b in stream)
    if op.kind == "fused_rows":
        stages = op.args["stages"]
        return (_fused_rows_block(b, stages) for b in stream)
    if op.kind == "flat_map":
        return (_flat_map_rows(b, op.fn) for b in stream)
    if op.kind == "filter":
        return (_filter_rows(b, op.fn) for b in stream)
    if op.kind == "map_batches":
        return _map_batches_stream(stream, op)
    if op.kind == "limit":
        return _limit_stream(stream, op.args["n"])
    if op.kind == "all2all":
        return _all2all(stream, op)
    if op.kind == "union":
        def union_gen():
            yield from stream
            for other_ops in op.args["others"]:
                yield from _execute(other_ops)
        return union_gen()
    if op.kind == "zip":
        return _zip_stream(stream, _execute(op.args["other"]))
    if op.kind == "join":
        return _join_exec(stream, op)
    raise ValueError(f"unknown op kind {op.kind}")


def _fused_rows_block(b: Block, stages) -> Block:
    """One pass over a block through a fused chain of row-wise stages
    (map/filter/flat_map) — no intermediate block per stage."""
    out: List[dict] = []
    samples: Dict[int, dict] = {}   # stage idx -> one observed output row
    for r in block_rows(b):
        items = [r]
        for si, (kind, fn) in enumerate(stages):
            if kind == "map_rows":
                items = [fn(x) for x in items]
            elif kind == "filter":
                items = [x for x in items if fn(x)]
            else:  # flat_map
                items = [y for x in items for y in fn(x)]
            if items and si not in samples:
                samples[si] = items[0]
            if not items:
                break
        out.extend(items)
    if not out:
        # No surviving rows: reconstruct the (empty) output SCHEMA from
        # rows the fused pass already observed — downstream ops (left
        # joins) rely on it, and re-running the UDFs would double work
        # and side effects. Semantics match per-stage execution: a
        # map/flat_map stage that never saw a row yields a schemaless
        # block (block_from_rows([]) == {}); filters pass schema
        # through.
        sample: Optional[dict] = "input"  # sentinel: input schema
        for si, (kind, _fn) in enumerate(stages):
            if kind == "filter":
                continue
            sample = samples.get(si)
            if sample is None:
                return {}
        if sample == "input":
            return {c: np.asarray(v)[:0] for c, v in b.items()}
        one = block_from_rows([sample])
        return {c: np.asarray(v)[:0] for c, v in one.items()}
    return block_from_rows(out)


def _source(op: _Op) -> Iterator[Block]:
    args = op.args
    if "parquet_paths" in args:
        # declarative parquet scan (kept lazy so the optimizer can
        # narrow `columns` before any file is opened)
        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import block_from_arrow
        for path in args["parquet_paths"]:
            yield block_from_arrow(
                pq.read_table(path, columns=args.get("columns")))
        return
    if "blocks" in args:
        yield from args["blocks"]
        return
    if "block_fns" in args:
        for fn in args["block_fns"]:
            out = fn()
            if isinstance(out, dict):
                yield out
            else:
                yield from out
        return
    raise ValueError("source op missing blocks")


def _map_rows(b: Block, fn) -> Block:
    return block_from_rows([fn(r) for r in block_rows(b)])


def _flat_map_rows(b: Block, fn) -> Block:
    out: List[dict] = []
    for r in block_rows(b):
        out.extend(fn(r))
    return block_from_rows(out)


def _filter_rows(b: Block, fn) -> Block:
    keep = np.asarray([bool(fn(r)) for r in block_rows(b)])
    if not keep.any():
        # zero rows but KEEP the columns: schema must survive an
        # all-filtered block (left joins emit right columns as nulls
        # based on it)
        return {c: np.asarray(v)[:0] for c, v in b.items()}
    return block_take(b, np.nonzero(keep)[0])


def _rebatch(stream: Iterator[Block],
             batch_size: Optional[int]) -> Iterator[Block]:
    if batch_size is None:
        yield from stream
        return
    buf: List[Block] = []
    rows = 0
    for b in stream:
        n = block_num_rows(b)
        if not n:
            continue
        buf.append(b)
        rows += n
        while rows >= batch_size:
            merged = block_concat(buf)
            yield block_slice(merged, 0, batch_size)
            rest = block_slice(merged, batch_size, block_num_rows(merged))
            buf = [rest] if block_num_rows(rest) else []
            rows = block_num_rows(rest)
    if rows:
        yield block_concat(buf)


def _convert_in(b: Block, fmt: str):
    if fmt == "pandas":
        return block_to_pandas(b)
    if fmt == "rows":
        return list(block_rows(b))
    return b


def _convert_out(out) -> Block:
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    if isinstance(out, list):
        return block_from_rows(out)
    try:
        import pandas as pd
        if isinstance(out, pd.DataFrame):
            return {c: out[c].to_numpy() for c in out.columns}
    except ImportError:
        pass
    raise TypeError(f"map_batches fn returned {type(out)}")


def _map_batches_stream(stream: Iterator[Block], op: _Op) -> Iterator[Block]:
    args = op.args
    fmt = args.get("batch_format", "numpy")
    concurrency = args.get("concurrency")
    batches = _rebatch(stream, args.get("batch_size"))
    fn = op.fn

    if isinstance(fn, type):
        # stateful UDF: one instance per pool worker
        if concurrency and _runtime_up():
            yield from _actor_pool_map(batches, fn, fmt, args)
            return
        inst = fn(*args.get("fn_constructor_args", ()),
                  **args.get("fn_constructor_kwargs", {}))
        for b in batches:
            yield _convert_out(inst(_convert_in(b, fmt)))
        return
    if concurrency and concurrency > 1 and _runtime_up():
        yield from _parallel_map(batches, fn, fmt, concurrency,
                                 args.get("num_cpus"),
                                 args.get("max_in_flight_bytes"))
        return
    for b in batches:
        yield _convert_out(fn(_convert_in(b, fmt)))


def _runtime_up() -> bool:
    try:
        import ray_tpu_torch
        return ray_tpu_torch.is_initialized()
    except Exception:
        return False


def _block_nbytes(b: Block) -> int:
    return sum(np.asarray(v).nbytes for v in b.values())


def _windowed(batches: Iterator[Block], submit, cap: int,
              max_bytes: Optional[int],
              on_done=None) -> Iterator[Block]:
    """THE in-order fan-out scheduler shared by the task-pool and
    actor-pool map operators: at most `cap` submissions (and, when
    set, `max_bytes` of input bytes) in flight; results yield in
    submission order (reference: TaskPoolMapOperator /
    ActorPoolMapOperator + the execution backpressure policies that
    bound per-op memory). `submit(block) -> (ref, meta)`;
    `on_done(meta)` runs when that submission's result is yielded."""
    import ray_tpu_torch

    window: List = []        # (ref, meta, input_nbytes) in order
    in_bytes = 0

    def drain_one():
        nonlocal in_bytes
        ref, meta, nb = window.pop(0)
        in_bytes -= nb
        out = ray_tpu_torch.get(ref, timeout=600)
        if on_done is not None:
            on_done(meta)
        return out

    for b in batches:
        nb = _block_nbytes(b)
        while window and (
                len(window) >= cap
                or (max_bytes is not None
                    and in_bytes + nb > max_bytes)):
            yield drain_one()
        ref, meta = submit(b)
        window.append((ref, meta, nb))
        in_bytes += nb
    while window:
        yield drain_one()


def _parallel_map(batches: Iterator[Block], fn, fmt: str,
                  concurrency: int, num_cpus: Optional[float] = None,
                  max_in_flight_bytes: Optional[int] = None
                  ) -> Iterator[Block]:
    """Stateless fan-out: one runtime task per batch."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _run_batch(fn_, b, fmt_):
        return _convert_out(fn_(_convert_in(b, fmt_)))

    task = _run_batch.options(num_cpus=num_cpus) \
        if num_cpus is not None else _run_batch
    yield from _windowed(batches,
                         lambda b: (task.remote(fn, b, fmt), None),
                         concurrency, max_in_flight_bytes)


class _MapWorker:
    """Actor-pool worker hosting ONE instance of a stateful map UDF
    (reference: ActorPoolMapOperator's _MapWorker)."""

    def __init__(self, cls_payload: bytes, ctor_args, ctor_kwargs):
        import cloudpickle
        cls = cloudpickle.loads(cls_payload)
        self.fn = cls(*ctor_args, **(ctor_kwargs or {}))

    def run(self, b, fmt: str):
        return _convert_out(self.fn(_convert_in(b, fmt)))


def _actor_pool_map(batches: Iterator[Block], cls, fmt: str,
                    args: dict) -> Iterator[Block]:
    """Stateful map over an actor pool: `concurrency` actors each
    construct the UDF once (model load amortized across every batch),
    batches go to the least-loaded actor, results yield in input
    order. In-flight work is bounded by 2 batches per actor plus the
    optional byte budget."""
    import cloudpickle

    import ray_tpu_torch
    concurrency = int(args.get("concurrency") or 1)
    num_cpus = args.get("num_cpus")
    max_bytes = args.get("max_in_flight_bytes")
    payload = cloudpickle.dumps(cls, protocol=5)
    opts = {"num_cpus": num_cpus} if num_cpus is not None else {}
    Worker = ray_tpu_torch.remote(_MapWorker).options(**opts) \
        if opts else ray_tpu_torch.remote(_MapWorker)
    actors = [Worker.remote(payload, args.get("fn_constructor_args", ()),
                            args.get("fn_constructor_kwargs", {}))
              for _ in range(concurrency)]
    try:
        loads = [0] * concurrency

        def submit(b):
            ai = min(range(concurrency), key=lambda i: loads[i])
            loads[ai] += 1
            return actors[ai].run.remote(b, fmt), ai

        def done(ai):
            loads[ai] -= 1

        # cap = 2 per actor: every actor busy + one queued
        yield from _windowed(batches, submit, concurrency * 2,
                             max_bytes, on_done=done)
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def _limit_stream(stream: Iterator[Block], n: int) -> Iterator[Block]:
    left = n
    for b in stream:
        rows = block_num_rows(b)
        if rows <= left:
            yield b
            left -= rows
        else:
            yield block_slice(b, 0, left)
            left = 0
        if left <= 0:
            return


def _all2all(stream: Iterator[Block], op: _Op) -> Iterator[Block]:
    if _runtime_up():
        # Distributed path: map/reduce over runtime tasks + object plane;
        # the driver streams refs, never the whole dataset (reference:
        # hash_shuffle.py / planner/exchange).
        from ray_tpu_torch.data.shuffle import distributed_all2all
        mode = op.args["mode"]
        if mode == "shuffle":
            spec = {"mode": "shuffle", "seed": op.args.get("seed")}
            yield from distributed_all2all(stream, spec)
            return
        if mode == "sort":
            spec = {"mode": "range", "key": op.args["key"],
                    "descending": op.args.get("descending", False)}
            yield from distributed_all2all(stream, spec)
            return
        if mode == "repartition":
            spec = {"mode": "split"}
            yield from distributed_all2all(stream, spec,
                                           n_out=op.args["n"])
            return
    yield from _all2all_local(stream, op)


def _all2all_local(stream: Iterator[Block], op: _Op) -> Iterator[Block]:
    mode = op.args["mode"]
    blocks = [b for b in stream if block_num_rows(b)]
    if not blocks:
        return
    merged = block_concat(blocks)
    total = block_num_rows(merged)
    if mode == "shuffle":
        rng = np.random.default_rng(op.args.get("seed"))
        idx = rng.permutation(total)
        merged = block_take(merged, idx)
        n_out = max(1, len(blocks))
    elif mode == "sort":
        key = op.args["key"]
        idx = np.argsort(merged[key], kind="stable")
        if op.args.get("descending"):
            idx = idx[::-1]
        merged = block_take(merged, idx)
        n_out = max(1, len(blocks))
    elif mode == "repartition":
        n_out = op.args["n"]
    else:
        raise ValueError(mode)
    per = max(1, total // n_out)
    for i in range(n_out):
        start = i * per
        end = total if i == n_out - 1 else (i + 1) * per
        if start >= total:
            break
        yield block_slice(merged, start, end)


def _join_exec(stream: Iterator[Block], op: _Op) -> Iterator[Block]:
    other = _execute(op.args["other"])
    key = op.args["on"]
    jt, suffix = op.args["join_type"], op.args["suffix"]
    if _runtime_up():
        from ray_tpu_torch.data.shuffle import distributed_join
        yield from distributed_join(stream, other, key, jt, suffix)
        return
    # local fallback (no cluster): concat both sides, one in-driver join
    from ray_tpu_torch.data.shuffle import join_blocks
    lblocks = [b for b in stream if block_num_rows(b)]
    rall = list(other)
    rblocks = [b for b in rall if block_num_rows(b)]
    # a zero-row right side still carries SCHEMA: left joins must emit
    # its columns as nulls rather than silently change shape
    rb = block_concat(rblocks) if rblocks else \
        next((b for b in rall if len(b) > 0), None)
    out = join_blocks(block_concat(lblocks) if lblocks else None,
                      rb, key, jt, suffix)
    if block_num_rows(out):
        yield out


def _zip_stream(a: Iterator[Block], b: Iterator[Block]) -> Iterator[Block]:
    abuf: List[Block] = []
    bbuf: List[Block] = []

    def pull(it, buf, need):
        have = sum(block_num_rows(x) for x in buf)
        while have < need:
            try:
                blk = next(it)
            except StopIteration:
                break
            buf.append(blk)
            have += block_num_rows(blk)

    while True:
        pull(a, abuf, 1)
        pull(b, bbuf, 1)
        na = sum(block_num_rows(x) for x in abuf)
        nb = sum(block_num_rows(x) for x in bbuf)
        n = min(na, nb)
        if n == 0:
            return
        ma, mb = block_concat(abuf), block_concat(bbuf)
        out = {}
        out.update(block_slice(ma, 0, n))
        for k, v in block_slice(mb, 0, n).items():
            out[k if k not in out else f"{k}_1"] = v
        yield out
        abuf = [block_slice(ma, n, na)] if na > n else []
        bbuf = [block_slice(mb, n, nb)] if nb > n else []
