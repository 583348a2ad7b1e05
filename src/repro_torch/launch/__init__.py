"""Launchers of the port: the serving loop (``launch.serve``), the trainer
CLI (``launch.train``) and mesh construction (``launch.mesh``)."""
