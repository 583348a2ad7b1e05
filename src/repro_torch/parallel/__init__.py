"""Parallelism of the port (``repro.parallel``): the logical-axis rule
tables that lay the model out over a (data, model) or (pod, data, model)
``DeviceMesh``. The GPipe pipeline over ``pod`` is not ported yet
(ROADMAP.md, Queue 1)."""

from .rules import (NamedSharding, logical_shardings, make_rules,
                    mesh_shape, sanitize_spec, sanitized_shardings)

__all__ = ["make_rules", "logical_shardings", "sanitize_spec",
           "sanitized_shardings", "NamedSharding", "mesh_shape"]
