"""The port's serve plane. Only ``fault.py`` (``DeadlineExceeded`` and
the fault-tolerance series the engine counts into) is ported so far."""
