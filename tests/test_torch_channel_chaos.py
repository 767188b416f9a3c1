"""The port's channel chaos plane (ray_tpu_torch.dag.channel
ChannelChaos: Config.testing_channel_failure's delay, drop and kill
rules on the shm ring) held to the JAX package's own tests.

``tests/test_zz_channel_chaos.py`` runs here unedited
(``_torch_ported.py``), with every ``ray_tpu`` name rewritten to
``ray_tpu_torch``. No test is left out.
"""

import pytest

from _torch_ported import adopt, ported

pytestmark = pytest.mark.chaos

adopt(ported("test_zz_channel_chaos"), globals())
