"""Models the port runs: the dense, MoE and VLM transformer families,
whisper, rwkv6 and zamba2."""
from repro_torch.models.factory import (Model, get_model, input_specs,
                                        make_batch, param_specs)

__all__ = ["Model", "get_model", "input_specs", "make_batch", "param_specs"]
