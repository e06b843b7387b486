"""Model zoo of the port: symbol definitions, as in `mxnet_tpu/models`.
The transformer LM is the first."""
from .transformer import get_transformer_lm, transformer_block

__all__ = ["get_transformer_lm", "transformer_block"]
