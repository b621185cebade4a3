"""Models the port runs: the dense transformer family."""
from repro_torch.models.factory import Model, get_model

__all__ = ["Model", "get_model"]
