"""LM serving on the card: the PyTorch port of `mxnet_tpu.serving`.

`ServingEngine` continuously batches `ServeRequest`s over the programs of
`TransformerKVModel` (paged K/V cache with prefix caching by default,
slot cache with ``paged=False``), and resolves every request with its
tokens or a typed `ServeError`.  See `engine` for what this port covers
and what waits for later slices.
"""
from .decode import TransformerKVModel
from .engine import ServeRequest, ServingEngine
from .errors import (ServeBlocksExhausted, ServeCancelled,
                     ServeDeadlineExceeded, ServeEngineDead, ServeError,
                     ServeOverload, ServeTimeout)
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache, pool_bytes
from .sampling import sample_tokens

__all__ = ["TransformerKVModel", "ServeRequest", "ServingEngine",
           "ServeError", "ServeTimeout", "ServeOverload",
           "ServeDeadlineExceeded", "ServeCancelled", "ServeBlocksExhausted",
           "ServeEngineDead", "BlockAllocator", "PrefixCache", "TRASH_BLOCK",
           "pool_bytes", "sample_tokens"]
