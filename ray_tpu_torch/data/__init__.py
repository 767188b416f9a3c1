"""Streaming datasets (reference capability: python/ray/data — Dataset at
data/dataset.py:189, read_api.py, streaming executor). Lazy plans over
columnar numpy blocks, generator-streamed with optional task fan-out;
iter_device_batches stages batches onto the card with prefetch.

The port's copy of ``ray_tpu/data``: host code over numpy blocks, with
pandas, pyarrow and torch imported only where a call needs them (the
card's machine has neither pandas nor pyarrow), so a map task loads
none of them unless its function does."""

from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (from_blocks, from_items, from_numpy,
                                     from_pandas, range,
                                     read_binary_files, read_csv,
                                     read_images, read_json, read_numpy, read_sql,
                                     read_parquet, read_text,
                                     read_tfrecord, read_webdataset,
                                     write_csv,
                                     write_json, write_parquet,
                                     write_tfrecord)
from ray_tpu_torch.data.iterator import DataIterator

__all__ = [
    "Dataset", "DataIterator", "from_blocks", "from_items", "from_numpy",
    "from_pandas", "range", "read_binary_files", "read_csv",
    "read_images", "read_json", "read_numpy", "read_sql",
    "read_parquet", "read_text", "read_tfrecord", "read_webdataset",
    "write_csv",
    "write_json", "write_parquet", "write_tfrecord",
]
