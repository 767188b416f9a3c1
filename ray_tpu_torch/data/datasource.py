"""Datasources: creation + IO (reference: python/ray/data/read_api.py,
data/datasource/). Files become one source block-fn per file/fragment so
reads stream lazily into the pipeline."""

from __future__ import annotations

import glob as _glob
import json as _json
import os
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.data.block import (Block, block_from_arrow, block_from_items,
                                block_from_rows, block_num_rows,
                                block_slice, block_to_arrow)
from ray_tpu_torch.data.dataset import Dataset, _Op


def _source_ds(name: str, **args) -> Dataset:
    return Dataset([_Op(name, "source", None, args)])


def from_blocks(blocks: List[Block]) -> Dataset:
    return _source_ds("from_blocks", blocks=blocks)


def from_items(items: Sequence[Any], *,
               block_size: int = 4096) -> Dataset:
    import builtins
    items = list(items)
    blocks = [block_from_items(items[i:i + block_size])
              for i in builtins.range(0, max(len(items), 1), block_size)]
    return _source_ds("from_items", blocks=blocks)


def range(n: int, *, block_size: int = 65536) -> Dataset:  # noqa: A001
    import builtins
    fns = []
    for start in builtins.range(0, n, block_size):
        end = min(start + block_size, n)
        fns.append(lambda s=start, e=end: {"id": np.arange(s, e)})
    return _source_ds("range", block_fns=fns)


def from_numpy(arr, column: str = "data") -> Dataset:
    """A single ndarray (one column) or a dict of same-length ndarrays."""
    if isinstance(arr, dict):
        return _source_ds("from_numpy",
                          blocks=[{k: np.asarray(v)
                                   for k, v in arr.items()}])
    return _source_ds("from_numpy", blocks=[{column: np.asarray(arr)}])


def from_pandas(df) -> Dataset:
    return _source_ds("from_pandas",
                      blocks=[{c: df[c].to_numpy() for c in df.columns}])


def _expand(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if not f.startswith(".")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


def read_parquet(paths, *, columns: Optional[List[str]] = None) -> Dataset:
    """(reference: read_api.py:943 read_parquet). The source op is
    DECLARATIVE (paths + columns, files opened at execution) so the
    plan optimizer can push a later select_columns into the scan —
    parquet then reads only the projected columns off disk."""
    return _source_ds("read_parquet", parquet_paths=_expand(paths),
                      columns=list(columns) if columns is not None
                      else None)


def read_csv(paths, **read_kwargs) -> Dataset:
    import pyarrow.csv as pacsv
    files = _expand(paths)

    def make(path):
        def fn():
            return block_from_arrow(pacsv.read_csv(path))
        return fn
    return _source_ds("read_csv", block_fns=[make(p) for p in files])


def read_json(paths) -> Dataset:
    files = _expand(paths)

    def make(path):
        def fn():
            rows = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(_json.loads(line))
            return block_from_rows(rows)
        return fn
    return _source_ds("read_json", block_fns=[make(p) for p in files])


def read_text(paths) -> Dataset:
    files = _expand(paths)

    def make(path):
        def fn():
            with open(path) as f:
                lines = [ln.rstrip("\n") for ln in f]
            return {"text": np.asarray(lines, dtype=object)}
        return fn
    return _source_ds("read_text", block_fns=[make(p) for p in files])


def read_tfrecord(paths, *, verify_crc: bool = True) -> Dataset:
    """TFRecord files of tf.train.Example protos, one block per file —
    WITHOUT TensorFlow (native framing + proto codec, data/tfrecord.py;
    reference capability: data/read_api.py read_tfrecords)."""
    from ray_tpu_torch.data import tfrecord as tfr
    files = _expand(paths)

    def make(path):
        def fn():
            rows = [tfr.decode_example(rec)
                    for rec in tfr.read_records(
                        path, verify_crc=verify_crc)]
            return tfr.rows_to_block(rows)
        return fn
    return _source_ds("read_tfrecord",
                      block_fns=[make(p) for p in files])


def _expand_files(paths) -> List[str]:
    """Like _expand but RECURSES into directories (class-subfolder
    image layouts: data/cat/x.png) and never returns a directory."""
    out: List[str] = []
    for p in _expand(paths):
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                # prune hidden dirs (.git, .ipynb_checkpoints) like the
                # top-level dot filter
                dirs[:] = [d for d in dirs if not d.startswith(".")]
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith("."))
        else:
            out.append(p)
    return sorted(out)


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """One row per file: {"bytes": ...} (+ "path") — the multimodal
    ingest workhorse (reference: read_api.py:2375 read_binary_files).
    Directories are walked recursively."""
    files = _expand_files(paths)

    def make(path):
        def fn():
            with open(path, "rb") as f:
                data = f.read()
            b: Block = {"bytes": np.asarray([data], dtype=object)}
            if include_paths:
                b["path"] = np.asarray([path], dtype=object)
            return b
        return fn
    return _source_ds("read_binary_files",
                      block_fns=[make(p) for p in files])


def read_images(paths, *, size: Optional[tuple] = None,
                mode: Optional[str] = None,
                include_paths: bool = False) -> Dataset:
    """Image files -> {"image": (1, H, W, C) uint8} rows (reference:
    read_api.py:1134 read_images; PIL decodes — optional dependency,
    gated with a clear error). Pass ``size=(H, W)`` to resize on read
    (required if downstream batching concatenates across images of
    different shapes), ``mode`` (e.g. "RGB"/"L") to convert.
    Directories are walked recursively (class-subfolder layouts)."""
    files = _expand_files(paths)

    def make(path):
        def fn():
            try:
                from PIL import Image
            except ImportError as e:  # pragma: no cover - env-specific
                raise RuntimeError(
                    "read_images needs pillow (PIL); install it or use "
                    "read_binary_files + your own decoder") from e
            img = Image.open(path)
            if mode is not None:
                img = img.convert(mode)
            if size is not None:
                img = img.resize((size[1], size[0]))  # PIL takes (W, H)
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            b: Block = {"image": arr[None, ...]}
            if include_paths:
                b["path"] = np.asarray([path], dtype=object)
            return b
        return fn
    return _source_ds("read_images", block_fns=[make(p) for p in files])


def read_webdataset(paths, *, include_keys: bool = False,
                    columns: Optional[List[str]] = None) -> Dataset:
    """WebDataset-style tar shards: members grouped by their path minus
    extension (WebDataset semantics: ``a/0001.jpg`` + ``a/0001.cls``
    form sample ``a/0001``), one ROW per sample with one column per
    extension (reference: read_api.py read_webdataset — there via the
    webdataset package; here a stdlib tarfile codec). Decode with
    map/map_batches (e.g. PIL for images, int(...) for labels).

    One block per shard; directories walk recursively but only
    ``.tar``/``.tar.gz``/``.tgz`` members are read (published sets ship
    index/README sidecars). Shards with DIFFERING extension sets yield
    ragged schemas — pass ``columns`` to pin the schema (missing
    payloads become None) when shards are heterogeneous."""
    import tarfile
    files = [p for p in _expand_files(paths)
             if p.endswith((".tar", ".tar.gz", ".tgz"))]

    def make(path):
        def fn():
            rows = []
            cur_key, cur = None, {}
            with tarfile.open(path) as tf:
                for m in tf:
                    if not m.isfile():
                        continue
                    dirpart, base = os.path.split(m.name)
                    if "." not in base:
                        continue
                    stem, ext = base.split(".", 1)
                    key = os.path.join(dirpart, stem) if dirpart else stem
                    if key != cur_key:
                        if cur:
                            rows.append(cur)
                        cur_key, cur = key, {}
                        if include_keys:
                            cur["__key__"] = key
                    cur[ext] = tf.extractfile(m).read()
                if cur:
                    rows.append(cur)
            keys = (list(columns) + (["__key__"] if include_keys else [])
                    if columns is not None
                    else sorted({k for r in rows for k in r}))
            # object-dtype columns: numpy's S dtype silently strips
            # trailing NUL bytes from binary payloads
            return {k: np.asarray([r.get(k) for r in rows],
                                  dtype=object)
                    for k in keys}
        return fn
    return _source_ds("read_webdataset",
                      block_fns=[make(p) for p in files])


def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             block_size: int = 4096) -> Dataset:
    """Rows of a SQL query as blocks (reference: read_api.py read_sql —
    there over any DBAPI connection; same contract here:
    ``connection_factory`` returns a DBAPI2 connection, e.g.
    ``lambda: sqlite3.connect(path)``). The query runs lazily at
    execution; results stream in ``block_size``-row blocks."""
    def gen():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            while True:
                rows = cur.fetchmany(block_size)
                if not rows:
                    break
                yield {c: np.asarray([r[i] for r in rows])
                       for i, c in enumerate(cols)}
        finally:
            conn.close()

    # the source executor accepts callables returning block iterators
    return _source_ds("read_sql", block_fns=[gen])


def read_numpy(paths) -> Dataset:
    files = _expand(paths)

    def make(path):
        def fn():
            return {"data": np.load(path)}
        return fn
    return _source_ds("read_numpy", block_fns=[make(p) for p in files])


# --- writes -----------------------------------------------------------------

def write_parquet(ds: Dataset, path: str) -> None:
    import pyarrow.parquet as pq
    os.makedirs(path, exist_ok=True)
    for i, b in enumerate(ds.iter_blocks()):
        if block_num_rows(b):
            pq.write_table(block_to_arrow(b),
                           os.path.join(path, f"part-{i:05d}.parquet"))


def write_csv(ds: Dataset, path: str) -> None:
    import pyarrow.csv as pacsv
    os.makedirs(path, exist_ok=True)
    for i, b in enumerate(ds.iter_blocks()):
        if block_num_rows(b):
            pacsv.write_csv(block_to_arrow(b),
                            os.path.join(path, f"part-{i:05d}.csv"))


def write_tfrecord(ds: Dataset, path: str) -> None:
    """One TFRecord file of tf.train.Example protos per block —
    readable by TF input pipelines (masked-crc32c framing)."""
    from ray_tpu_torch.data import tfrecord as tfr
    from ray_tpu_torch.data.block import block_rows
    os.makedirs(path, exist_ok=True)
    for i, b in enumerate(ds.iter_blocks()):
        if block_num_rows(b):
            tfr.write_records(
                os.path.join(path, f"part-{i:05d}.tfrecord"),
                (tfr.encode_example(r) for r in block_rows(b)))


def write_json(ds: Dataset, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    from ray_tpu_torch.data.block import block_rows
    for i, b in enumerate(ds.iter_blocks()):
        if block_num_rows(b):
            with open(os.path.join(path, f"part-{i:05d}.jsonl"), "w") as f:
                for r in block_rows(b):
                    f.write(_json.dumps(
                        {k: (v.tolist() if isinstance(v, np.ndarray)
                             else v.item() if isinstance(v, np.generic)
                             else v) for k, v in r.items()}) + "\n")
