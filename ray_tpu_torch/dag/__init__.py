"""The port's ``dag`` package: so far only the pytree helpers the
checkpoint plane uses (``ring.py``)."""
