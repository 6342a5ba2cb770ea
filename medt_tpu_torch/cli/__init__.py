"""Command-line entry points of the port: ``test`` and ``predict``."""
