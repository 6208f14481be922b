"""Serving benchmarks of the port (new files; the reference's live under
``benchmarks/``): ``serve_cluster`` and ``serve_trace``, each the same
recipe and assertions as its reference, run as
``python -m repro_torch.benchmarks.<name>``."""
