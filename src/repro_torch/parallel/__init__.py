"""Parallelism of the port (``repro.parallel``): the logical-axis rule
tables that lay the model out over a (data, model) or (pod, data, model)
``DeviceMesh``, and the GPipe pipeline over ``pod`` (``pipeline``, and
the pipelined LM training step of ``pipelined_lm``)."""

from .rules import (NamedSharding, fsdp_dim, logical_shardings, make_rules,
                    mesh_shape, sanitize_spec, sanitized_shardings)
from .pipeline import pipeline_forward, pipeline_stages

__all__ = ["make_rules", "logical_shardings", "sanitize_spec",
           "sanitized_shardings", "NamedSharding", "mesh_shape", "fsdp_dim",
           "pipeline_forward", "pipeline_stages"]
