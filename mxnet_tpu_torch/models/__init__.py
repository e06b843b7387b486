"""Model zoo of the port: symbol definitions, as in `mxnet_tpu/models`.
The transformer LM and the MLP so far."""
from .mlp import get_mlp
from .transformer import get_transformer_lm, transformer_block

__all__ = ["get_mlp", "get_transformer_lm", "transformer_block"]
