"""Launchers of the port (so far the serving loop, ``launch.serve``)."""
