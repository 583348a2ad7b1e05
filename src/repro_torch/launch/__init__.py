"""Launchers of the port: the serving loop (``launch.serve``), the trainer
CLI (``launch.train``), mesh construction (``launch.mesh``) and the
per-cell step functions (``launch.specs``)."""
