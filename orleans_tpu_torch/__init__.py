"""orleans_tpu_torch: the device tier of orleans_tpu on PyTorch and CUDA.

The same virtual-actor dispatch as the JAX package ``orleans_tpu``, with
actor state in torch tensors on an explicit ``torch.device`` and the two
hot-op kernels (fan-in segment sum, within-destination rank) written by
hand in CUDA C++ for Hopper (``ops/csrc``). Shards are a leading tensor
dimension: ``[n_shards, C+1, ...]`` slot pools and ``[n_shards, B, ...]``
per-tick operands, so an n-shard mesh runs on one card.

This package imports torch and numpy only — never jax, never
``orleans_tpu``.
"""

__all__ = ["config", "core", "dispatch", "interop", "observability", "ops",
           "parallel"]
