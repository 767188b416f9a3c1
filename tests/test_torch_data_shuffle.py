"""The port's distributed shuffles (ray_tpu_torch.data.shuffle: random
shuffle, sort, groupby, repartition and joins as map/reduce tasks over a
two-node cluster) held to the JAX package's own tests.

``tests/test_data_shuffle.py`` runs here unedited (``_torch_ported.py``),
with every ``ray_tpu`` name rewritten to ``ray_tpu_torch``. No test is
left out.
"""

from _torch_ported import adopt, ported

adopt(ported("test_data_shuffle"), globals())
