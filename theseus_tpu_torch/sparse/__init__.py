"""Block-sparse normal-equation machinery (JAX counterpart: theseus_tpu/sparse/)."""
