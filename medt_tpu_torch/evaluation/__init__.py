"""Evaluation helpers of the port: sliding-window inference and the
best-checkpoint sweep."""
from .sliding_window import sliding_window_inference, window_grid
from .sweep import evaluate_png_dir, sweep_checkpoint_grid

__all__ = ["evaluate_png_dir", "sliding_window_inference",
           "sweep_checkpoint_grid", "window_grid"]
