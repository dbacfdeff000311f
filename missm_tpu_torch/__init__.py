"""PyTorch/CUDA port of missm_tpu (the JAX package stays the reference).

Imports torch only: never jax, never missm_tpu.
"""
