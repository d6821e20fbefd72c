"""Problem conversion and example problems (JAX counterpart: theseus_tpu/utils/__init__.py)."""
