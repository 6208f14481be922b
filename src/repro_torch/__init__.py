"""PyTorch/CUDA port of ``repro``: the serving path on an NVIDIA H100.

The JAX package ``repro`` stays the reference. This package imports
``torch`` and never ``jax``, and nothing of ``repro``: the JAX-free modules
it needs are copied here under the same paths and names. Entry points take
``device=`` and default to ``"cuda"``; without a card they raise unless the
caller asks for ``device="cpu"``.
"""
