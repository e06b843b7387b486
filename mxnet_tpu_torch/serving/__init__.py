"""LM serving on the card: the PyTorch port of `mxnet_tpu.serving`.

`ServingEngine` continuously batches `ServeRequest`s over the programs of
`TransformerKVModel` (paged K/V cache with prefix caching by default,
slot cache with ``paged=False``), scopes its launch failures, and
resolves every request with its tokens or a typed `ServeError`;
`ReplicaRouter` dispatches over several engines and fails a dead
replica's requests over through the `RequestJournal`; `spec` holds
speculative decoding's drafters; `tiers.HostBlockTier` is the host-DRAM
tier under the paged pool.  A model with ``moe_experts`` serves a top-1
routed mixture of experts and reports its routing
(`ServingEngine.expert_load`); `handoff` is the disaggregated fleet's
prefill-to-decode transfer (``ReplicaRouter(disagg=True)``);
`autoscale.AutoScaler` resizes a fleet off its load and
`gateway.ServeGateway` serves it over HTTP with server-sent events.
``ServingEngine(ctx=mesh)`` is a sub-mesh replica (`sharded`), and
`ReplicaRouter.from_mesh` a fleet of them.  See `engine` for what this
port covers.
"""
from .autoscale import AutoScaler, autoscale_enabled
from .decode import TransformerKVModel
from .engine import ReplicaRouter, ServeRequest, ServingEngine
from .gateway import ServeGateway, gateway_enabled, http_status
from .handoff import HandoffTicket, disagg_enabled
from .errors import (ServeBlocksExhausted, ServeCacheInvalidated,
                     ServeCancelled, ServeDeadlineExceeded, ServeEngineDead,
                     ServeError, ServeOverload, ServeQuantError,
                     ServeQuarantined, ServeTimeout)
from .journal import RequestJournal, journal_enabled
from .paged import TRASH_BLOCK, BlockAllocator, PrefixCache, pool_bytes
from .sampling import sample_tokens
from .sharded import ShardedKVModel
from .spec import Drafter, ModelDrafter, NgramDrafter, make_drafter
from .tiers import HostBlockTier, pack_block_run

__all__ = ["TransformerKVModel", "ServeRequest", "ServingEngine",
           "ReplicaRouter", "HandoffTicket", "disagg_enabled",
           "ServeGateway", "gateway_enabled", "http_status",
           "AutoScaler", "autoscale_enabled",
           "RequestJournal", "journal_enabled",
           "ServeError", "ServeTimeout", "ServeOverload",
           "ServeDeadlineExceeded", "ServeCancelled", "ServeQuarantined",
           "ServeBlocksExhausted", "ServeQuantError", "ServeCacheInvalidated",
           "ServeEngineDead", "HostBlockTier", "pack_block_run",
           "BlockAllocator", "PrefixCache", "TRASH_BLOCK", "pool_bytes",
           "sample_tokens", "Drafter", "NgramDrafter", "ModelDrafter",
           "make_drafter", "ShardedKVModel"]
