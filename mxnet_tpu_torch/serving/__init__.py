"""LM serving on the card: the PyTorch port of `mxnet_tpu.serving`.

`ServingEngine` continuously batches `ServeRequest`s over the programs of
`TransformerKVModel` (paged K/V cache by default, slot cache with
``paged=False``).  See `engine` for what this slice covers and what
waits for later ones.
"""
from .decode import TransformerKVModel
from .engine import ServeRequest, ServingEngine
from .errors import ServeBlocksExhausted, ServeError, ServeTimeout
from .paged import TRASH_BLOCK, BlockAllocator, pool_bytes
from .sampling import sample_tokens

__all__ = ["TransformerKVModel", "ServeRequest", "ServingEngine",
           "ServeError", "ServeTimeout", "ServeBlocksExhausted",
           "BlockAllocator", "TRASH_BLOCK", "pool_bytes", "sample_tokens"]
