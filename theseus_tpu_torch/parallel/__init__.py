"""Batch-axis and GBP factor-axis sharding over several devices (JAX counterpart: theseus_tpu/parallel/__init__.py)."""

from .sharding import (
    aux_pspecs,
    carry_pspecs,
    make_mesh,
    shard_gbp_factors,
    shard_map_solve,
    shard_problem,
    state_pspecs,
)

__all__ = [
    "aux_pspecs",
    "carry_pspecs",
    "make_mesh",
    "shard_gbp_factors",
    "shard_map_solve",
    "shard_problem",
    "state_pspecs",
]
