"""Evaluation helpers of the port: sliding-window inference."""
from .sliding_window import sliding_window_inference, window_grid

__all__ = ["sliding_window_inference", "window_grid"]
