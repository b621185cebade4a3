"""Models the port runs: the dense transformer family, rwkv6 and zamba2."""
from repro_torch.models.factory import Model, get_model

__all__ = ["Model", "get_model"]
