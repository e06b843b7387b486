"""LM serving on the card: the PyTorch port of `mxnet_tpu.serving`.

`ServingEngine` continuously batches `ServeRequest`s over the programs of
`TransformerKVModel` (paged K/V cache with prefix caching by default,
slot cache with ``paged=False``), scopes its launch failures, and
resolves every request with its tokens or a typed `ServeError`;
`ReplicaRouter` dispatches over several engines and fails a dead
replica's requests over through the `RequestJournal`; `spec` holds
speculative decoding's drafters.  See `engine` for what this port
covers and what waits for later slices.
"""
from .decode import TransformerKVModel
from .engine import ReplicaRouter, ServeRequest, ServingEngine
from .errors import (ServeBlocksExhausted, ServeCacheInvalidated,
                     ServeCancelled, ServeDeadlineExceeded, ServeEngineDead,
                     ServeError, ServeOverload, ServeQuarantined,
                     ServeTimeout)
from .journal import RequestJournal, journal_enabled
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache, pool_bytes
from .sampling import sample_tokens
from .spec import Drafter, ModelDrafter, NgramDrafter, make_drafter

__all__ = ["TransformerKVModel", "ServeRequest", "ServingEngine",
           "ReplicaRouter", "RequestJournal", "journal_enabled",
           "ServeError", "ServeTimeout", "ServeOverload",
           "ServeDeadlineExceeded", "ServeCancelled", "ServeQuarantined",
           "ServeBlocksExhausted", "ServeCacheInvalidated", "ServeEngineDead",
           "BlockAllocator", "PrefixCache", "TRASH_BLOCK", "pool_bytes",
           "sample_tokens", "Drafter", "NgramDrafter", "ModelDrafter",
           "make_drafter"]
