"""The port's observability planes: the event buffer, the metrics
registry, request tracing, the device monitor and the forensics state
providers, each a copy (or, for the device monitor, a ``torch.cuda``
counterpart) of the ``ray_tpu/util`` module of the same name."""
