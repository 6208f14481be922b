"""Counterparts of the repository's ``examples/*.py``, run as
``python -m repro_torch.examples.<name>``."""
