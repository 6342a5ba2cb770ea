"""Utilities of the port: the weight carrier from the JAX package's trees,
and logging helpers."""
from .logging import Logger, ThroughputMeter, chk_mkdir
from .weights import export_for_model, export_state_dict, to_state_dict

__all__ = ["Logger", "ThroughputMeter", "chk_mkdir", "export_for_model",
           "export_state_dict", "to_state_dict"]
