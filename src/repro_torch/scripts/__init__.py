"""Counterparts of the repository's ``scripts/*.py``, run as
``python -m repro_torch.scripts.<name>``."""
