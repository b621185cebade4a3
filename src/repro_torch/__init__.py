"""repro_torch: MemForest on PyTorch, with hand-written CUDA kernels for Hopper.

    from repro_torch import MemForestSystem
    mf = MemForestSystem()                  # the CUDA device; raises without one
    mf = MemForestSystem(device="cpu")      # plain PyTorch versions of the kernels
"""
from repro_torch.config import MemForestConfig
from repro_torch.core.memforest import MemForestSystem

__version__ = "0.1.0"

__all__ = ["MemForestConfig", "MemForestSystem"]
