"""Fused geometric kernels and small linear algebra (JAX counterpart: theseus_tpu/ops/__init__.py)."""
