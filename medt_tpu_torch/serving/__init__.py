"""Serving of the port: the batched inference engine."""
from .engine import InferenceEngine, QueueFullError

__all__ = ["InferenceEngine", "QueueFullError"]
