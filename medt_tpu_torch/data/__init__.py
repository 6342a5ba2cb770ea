"""Data of the port: in-memory synthetic sets (numpy only)."""
from .synthetic import InMemoryDataset, blob_batch

__all__ = ["InMemoryDataset", "blob_batch"]
