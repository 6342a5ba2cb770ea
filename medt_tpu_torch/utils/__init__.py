"""Utilities of the port: the weight carrier from the JAX package's trees."""
from .weights import export_for_model, export_state_dict, to_state_dict

__all__ = ["export_for_model", "export_state_dict", "to_state_dict"]
