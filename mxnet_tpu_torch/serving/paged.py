"""Host-side block accounting and the prefix index of the paged K/V cache.

A port of `BlockAllocator`, `PrefixCache`, `pool_bytes` and `TRASH_BLOCK`
from `mxnet_tpu/serving/paged.py` (the port keeps its own copy rather than
import that package).  The device pool is
`(num_layers, 2, n_blocks, block_size, embed)`; a sequence holds
ceil(tokens / block_size) blocks, named in its block table.  Block 0 is
the TRASH block: padding rows and the unallocated tail of every table
point at it, so gathers stay in bounds at fixed shapes and padding
scatters land where no sequence reads.  It is never handed out.

Blocks are refcounted, so several sequences can share one.
`PrefixCache` is a radix tree over FULL-block token runs (node key = the
exact block_size-token tuple, path = the chained prefix) mapping each
cached run to the physical block that already holds its K/V.  Admission
walks its prompt down the tree, `acquire`s every matched block and
prefills only the uncached suffix.  A registered block whose refcount
drops to zero does not go back to the free list: it PARKS in an LRU
pool and is evicted (leaves before roots) only under allocation
pressure or past ``pool_cap``, so a hot system prompt survives between
requests.

The index reaches below the pool into the host-DRAM tier
(`tiers.HostBlockTier`, ``MXNET_SERVE_TIER``): when the LRU evicts a
parked block, the engine's ``spill_hook`` may copy its K/V to the host,
and the node converts to host residency (``tier == "host"``, ``block``
the host handle) instead of detaching.  Host-resident nodes only ever
hang below device-resident ones, so `lookup_plan`'s tier-aware match is
a device run followed by a host run, which the engine restores before
the request proceeds (`restore_landed` flips a node back).  A host copy
stays valid after a restore (a registered block is never written again),
so re-evicting that node costs no second copy.  `invalidate` detaches a
node and its subtree (the quantization scrub after a logit-gate trip).

Allocation order is the JAX one, so both engines hand out the same
block ids, evict the same blocks and park the same ones.
"""
from __future__ import annotations

from collections import OrderedDict

from .. import chaos
from ..base import MXNetError

__all__ = ["TRASH_BLOCK", "pool_bytes", "BlockAllocator", "PrefixCache"]

TRASH_BLOCK = 0


def pool_bytes(num_layers, n_blocks, block_size, num_embed, itemsize=4):
    """Device bytes of the paged K/V pool
    `(num_layers, 2, n_blocks, block_size, num_embed)`."""
    return (int(num_layers) * 2 * int(n_blocks) * int(block_size)
            * int(num_embed) * int(itemsize))


class BlockAllocator:
    """Refcounted free list over the device block pool (ids 1..n-1).

    Three disjoint states per usable block, every wrong transition loud:

    * **free**: on the free list, allocatable (`alloc`);
    * **held**: refcount >= 1; `acquire` adds a reader, `release` drops
      one and hands back the blocks that reached zero (the engine parks
      registered prefix blocks and `reclaim`s the rest: the allocator
      never decides cache policy);
    * **parked**: refcount 0 but retained by the prefix cache; in no
      allocator structure until `reclaim` returns it to the free list
      (eviction) or `acquire` revives it (a prefix hit).

    A double release or a trash release raises: either would let two
    sequences alias one block, which corrupts a neighbour's context
    silently.
    """

    def __init__(self, n_blocks, block_size):
        if int(n_blocks) < 2:
            raise MXNetError(
                "BlockAllocator: need >= 2 blocks (one is the reserved "
                "trash block), got %d" % n_blocks)
        if int(block_size) < 1:
            raise MXNetError(
                "BlockAllocator: block_size must be >= 1, got %d"
                % block_size)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.reset()

    @property
    def capacity(self):
        """Usable blocks (pool minus the trash block)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        """Distinct physical blocks with refcount >= 1 (a block shared by
        k sequences counts once)."""
        return len(self._ref)

    @property
    def shared_blocks(self):
        """Physical blocks referenced by more than one holder."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, block):
        return self._ref.get(block, 0)

    def exclusive(self, block):
        """True when exactly one holder owns ``block``: the write
        precondition of every scatter target (the engine also requires
        the block to be absent from the prefix index, since a registered
        block may gain readers at any moment)."""
        return self._ref.get(block, 0) == 1

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache rows."""
        return -(-int(n_tokens) // self.block_size)

    def can_serve(self, n):
        """Whether the free list alone could serve ``n`` blocks now: after
        a denied `alloc`, True means the denial was chaos's
        ``block_exhaust`` draw, not exhaustion."""
        return int(n) <= len(self._free)

    def alloc(self, n):
        """``n`` fresh block ids at refcount 1, or None when the free list
        cannot serve them (or chaos's ``block_exhaust`` denies the
        attempt).  Never partial.  Parked prefix blocks do not count as
        free: the engine evicts them explicitly under pressure."""
        n = int(n)
        if n <= 0:
            return []
        if chaos.serve_block_exhaust():
            return None
        if n > len(self._free):
            return None
        blocks = self._free[-n:]
        del self._free[-n:]
        self._free_set.difference_update(blocks)
        for b in blocks:
            self._ref[b] = 1
        return list(reversed(blocks))

    def acquire(self, blocks):
        """Add one reader to each block: a held block's refcount bumps, a
        parked one revives at 1.  Acquiring the trash block or a free
        block raises: only blocks the prefix index vouches for may gain
        readers, anything else would alias a future allocation."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise MXNetError("BlockAllocator: acquiring the trash block")
            if b in self._free_set:
                raise MXNetError(
                    "BlockAllocator: acquiring free block %d (stale "
                    "prefix-index entry?)" % b)
            self._ref[b] = self._ref.get(b, 0) + 1

    def release(self, blocks):
        """Drop one reader from each block; returns the blocks whose
        refcount reached zero (the caller parks or `reclaim`s them)."""
        zeroed = []
        for b in blocks:
            if b == TRASH_BLOCK:
                raise MXNetError("BlockAllocator: freeing the trash block")
            c = self._ref.get(b)
            if c is None:
                raise MXNetError(
                    "BlockAllocator: double free of block %d" % b)
            if c == 1:
                del self._ref[b]
                zeroed.append(b)
            else:
                self._ref[b] = c - 1
        return zeroed

    def reclaim(self, blocks):
        """Return refcount-0 blocks to the free list (unregistered
        releases, prefix-cache evictions).  Reclaiming a held or free
        block raises."""
        for b in blocks:
            if b in self._ref:
                raise MXNetError(
                    "BlockAllocator: reclaiming held block %d" % b)
            if b in self._free_set or b == TRASH_BLOCK:
                raise MXNetError(
                    "BlockAllocator: reclaiming free block %d" % b)
            self._free.append(b)
            self._free_set.add(b)

    def free(self, blocks):
        """Release and reclaim in one step: the single-owner path, where
        no prefix cache retains refcount-0 blocks.  Raises as `release`
        does."""
        self.reclaim(self.release(blocks))

    def reset(self):
        """Forget every allocation: all usable blocks free."""
        self._free = list(range(self.n_blocks - 1, TRASH_BLOCK, -1))
        self._free_set = set(self._free)
        self._ref = {}            # block -> refcount (>= 1)

    def fragmentation(self, used_tokens, cached_blocks=0):
        """Internal fragmentation: the fraction of allocated token rows
        not holding a live token.  ``used_tokens`` counts each physical
        block's written rows once; ``cached_blocks`` adds the parked
        prefix pool to the allocated capacity (parked blocks are full, so
        callers include ``cached_blocks * block_size`` in
        ``used_tokens``).  0.0 with nothing allocated."""
        cap = (len(self._ref) + int(cached_blocks)) * self.block_size
        if cap <= 0:
            return 0.0
        return max(0.0, 1.0 - float(used_tokens) / cap)


class _PrefixNode:
    """One cached full-block token run: `key` is the exact block_size-
    token tuple, `block` the physical location of its K/V — a device
    block id while ``tier == "dev"``, a host-tier handle while
    ``tier == "host"`` — and the parent chain spells the whole prefix.
    ``host`` (dev-resident nodes only) remembers a still-valid host
    copy from an earlier spill/restore cycle, so re-evicting this node
    costs no second device→host transfer."""

    __slots__ = ("key", "block", "parent", "children", "tier", "host")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}
        self.tier = "dev"
        self.host = None


class PrefixCache:
    """Block-aligned radix index over cached K/V prefixes.

    Keys are the exact token tuples of FULL blocks (no lossy hashing:
    a hash collision would silently alias one prompt's K/V into
    another's attention — dict equality on the tuple makes the match
    exact; Python hashes the tuple internally for the walk).  Only full
    blocks participate: a partially-written block's tail is garbage, so
    it can never be shared.

    Lifecycle: the engine `insert`s a sequence's blocks as they FILL
    (eagerly — a concurrent request can share a block its writer still
    holds, which is where copy-on-write earns its keep), `lookup`s the
    longest cached prefix at admission, `park`s registered blocks whose
    refcount hits zero, and `evict`s parked blocks — oldest-first with
    leaf preference, so a prefix's tail dies before its root — only
    under allocation pressure (or past ``pool_cap``).

    Tiering hooks (both optional; without them this is the single-tier
    cache):

    * ``spill_hook(block, tokens, node)`` fires when the LRU evicts a
      parked device block, with the block id, the node's full token
      path, and the node itself — the structured eviction metadata any
      observer needs.  Returning a host-tier handle converts the node
      to host residency (the prefix stays findable); returning None
      detaches it exactly as before.  The evicted DEVICE block is
      returned to the caller for reclaim either way.
    * ``host_drop_hook(handle)`` fires whenever the cache drops its own
      reference to a host handle (node detach/orphan paths), so the
      owner can free the host storage.
    """

    def __init__(self, block_size, pool_cap=-1, spill_hook=None,
                 host_drop_hook=None):
        self.block_size = int(block_size)
        self.pool_cap = int(pool_cap)     # parked blocks retained; < 0 = all
        self.spill_hook = spill_hook
        self.host_drop_hook = host_drop_hook
        self._root = _PrefixNode(None, None, None)
        self._by_block = {}               # device block -> node
        self._by_host = {}                # host handle -> node
        self._parked = OrderedDict()      # block -> node, oldest first

    @property
    def cached_blocks(self):
        """Registered DEVICE blocks (live + parked)."""
        return len(self._by_block)

    @property
    def host_count(self):
        """Host-tier handles this index references (host-resident nodes
        plus retained host copies of device-resident ones) — must equal
        the tier's own `used` count, or someone leaked."""
        return len(self._by_host)

    @property
    def parked_count(self):
        """Refcount-0 blocks retained for reuse (the LRU pool)."""
        return len(self._parked)

    def _path_tokens(self, node):
        """The full token path root→``node`` (the exact tokens whose
        K/V the node's block holds) — the eviction hook's metadata."""
        keys = []
        while node is not self._root:
            keys.append(node.key)
            node = node.parent
        out = []
        for k in reversed(keys):
            out.extend(k)
        return out

    def _key(self, tokens, i):
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def lookup_plan(self, tokens):
        """The tier-aware match: ``(dev_blocks, host_nodes)`` — the
        longest cached FULL-block prefix of ``tokens`` split into its
        leading device-resident run (block ids, acquire-ready) and the
        host-resident run that follows (nodes, each carrying its host
        handle in ``.block`` — the engine's restore-then-acquire plan).
        Host under device is the only legal stacking (spills are
        bottom-up), so the walk flips exactly once; a device node BELOW
        a host one would mean the invariant broke — the walk stops
        there rather than hand out an unreachable plan.  Touches the
        matched parked path so hot prefixes move to the MRU end of the
        eviction order (recency IS the `_parked` OrderedDict order).
        The caller must `acquire` the device run before any operation
        that could evict (a parked match is still parked until
        acquired)."""
        dev, host = [], []
        node = self._root
        last_dev = self._root
        for i in range(len(tokens) // self.block_size):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            if child.tier == "host":
                host.append(child)
            elif host:
                break
            else:
                dev.append(child.block)
                last_dev = child
            node = child
        n = last_dev
        while n is not self._root:
            if n.block in self._parked:
                self._parked.move_to_end(n.block)
            n = n.parent
        return dev, host

    def lookup(self, tokens):
        """Device block ids of the longest cached FULL-block prefix of
        ``tokens`` (the tier-blind view; tier-aware callers use
        `lookup_plan`)."""
        return self.lookup_plan(tokens)[0]

    def insert(self, tokens, blocks, n_full):
        """Register the first ``n_full`` blocks of a sequence (its FULL
        blocks) along the tree path of ``tokens``.  A run already cached
        under a DIFFERENT physical device block keeps the existing copy
        (the walk continues through it, so deeper runs still register);
        a run already cached under the SAME block is a no-op.  A run
        cached only on the HOST tier is UPGRADED: the node repoints at
        the freshly prefilled device block and retains the host copy as
        a free re-spill (prefill of the same tokens under the same
        weights is deterministic, so the two copies are bit-identical).
        Returns the number of newly registered device blocks."""
        node = self._root
        added = 0
        for i in range(min(int(n_full), len(blocks))):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._by_block:
                    # this physical block already backs another run (it
                    # must not appear at two tree positions); stop here
                    break
                child = _PrefixNode(key, b, node)
                node.children[key] = child
                self._by_block[b] = child
                added += 1
            elif child.tier == "host":
                b = blocks[i]
                if b in self._by_block:
                    break
                child.host = child.block
                child.tier = "dev"
                child.block = b
                self._by_block[b] = child
                added += 1
            node = child
        return added

    def contains(self, block):
        return block in self._by_block

    def park(self, block):
        """A registered block's refcount hit zero: retain it in the LRU
        pool instead of freeing.  Returns the blocks evicted to honor
        ``pool_cap`` (the caller reclaims them); [] for an unregistered
        block — the caller frees it directly."""
        node = self._by_block.get(block)
        if node is None:
            return None
        self._parked[block] = node
        self._parked.move_to_end(block)
        evicted = []
        if self.pool_cap >= 0:
            while len(self._parked) > self.pool_cap:
                evicted.extend(self._evict_one())
        return evicted

    def unpark(self, blocks):
        """Blocks re-acquired through a prefix hit leave the LRU pool
        (they are live again; `acquire` holds the refcount)."""
        for b in blocks:
            self._parked.pop(b, None)

    def _evict_one(self):
        """Evict the oldest parked DEVICE leaf (a parked node's device
        children are always parked too — a live child would imply a
        live holder of the whole prefix — so device leaves exist
        whenever the pool is non-empty; preferring them keeps prefix
        ROOTS, the shareable part, alive longest; already-spilled host
        children hang below without pinning their parent).  With a
        ``spill_hook``, the node converts to host residency instead of
        detaching — eviction ORDER over device blocks is identical
        either way (regression-tested), only the node's afterlife
        differs."""
        for b, node in self._parked.items():
            if not any(c.tier == "dev" for c in node.children.values()):
                del self._parked[b]
                return [b] + self._spill_or_detach(node)
        # unreachable while the parked-subtree invariant holds; take the
        # oldest anyway (detaching orphans its subtree: unregistered,
        # parked descendants evicted with it) rather than looping
        b, node = next(iter(self._parked.items()))
        return self._drop_subtree(node)

    def _spill_or_detach(self, node):
        """A parked device node lost its block to eviction: convert it
        to host residency when a host copy exists (retained from an
        earlier cycle, or minted right now by the spill hook), detach
        it — dropping any orphaned host descendants — otherwise.
        Returns the parked device blocks detached with it (none while
        the parked-subtree invariant holds: an evictable node's
        children are all host)."""
        handle = node.host
        if handle is None and self.spill_hook is not None:
            handle = self.spill_hook(node.block, self._path_tokens(node),
                                     node)
        if handle is None:
            return self._drop_subtree(node)
        self._by_block.pop(node.block, None)
        node.block = handle
        node.tier = "host"
        node.host = None
        self._by_host[handle] = node
        return []

    def _drop_host_handle(self, handle):
        if handle is not None:
            self._by_host.pop(handle, None)
            if self.host_drop_hook is not None:
                self.host_drop_hook(handle)

    def drop_host(self, handle):
        """The host TIER evicted ``handle`` (its storage is already
        gone): detach the index's view of it.  A retained host copy of
        a device-resident node just loses the shortcut; a host-resident
        node detaches with its (host) subtree.  Returns the ORPHANED
        descendant handles for the caller to free from the tier —
        no ``host_drop_hook`` reentry from this path, the tier
        initiated it."""
        node = self._by_host.pop(handle, None)
        if node is None:
            return []
        if node.tier == "dev":
            node.host = None
            return []
        orphans = []
        self._detach(node)
        stack = list(node.children.values())
        node.children = {}
        while stack:
            d = stack.pop()
            if d.tier == "host":
                self._by_host.pop(d.block, None)
                orphans.append(d.block)
            else:  # dev under host: invariant breach — scrub defensively
                self._by_block.pop(d.block, None)
                self._parked.pop(d.block, None)
            stack.extend(d.children.values())
            d.children = {}
        return orphans

    def restore_landed(self, node, handle, dev_block):
        """A restore staged against host ``handle`` finished writing
        ``dev_block``: flip the node back to device residency, keep the
        host copy as a free re-spill.  Returns False when the node was
        upgraded or dropped in the transfer window (the restored block
        stays the sequence's private property — correct either way, the
        bytes came from the tier, not the tree)."""
        if self._by_host.get(handle) is not node or node.tier != "host" \
                or dev_block in self._by_block:
            return False
        node.tier = "dev"
        node.block = dev_block
        node.host = handle
        self._by_block[dev_block] = node
        return True

    def _detach(self, node):
        if node.tier == "dev":
            self._by_block.pop(node.block, None)
        else:
            self._by_host.pop(node.block, None)
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        node.parent = None

    def invalidate(self, blocks):
        """Detach the nodes backing ``blocks`` (and their entire
        subtrees — a child run's K/V is only meaningful under its
        parent's context) from the index: the integrity-scrub path
        (quantization scale corruption tripping the serving logit
        gate).  Live holders keep their own table entries — refcounts
        are the allocator's business — the runs just stop being
        findable, so no future lookup can re-acquire them.  Host copies
        under detached nodes drop through ``host_drop_hook``.  Returns
        the PARKED device blocks that were detached (refcount 0,
        unreferenced now): the caller reclaims them."""
        out = []
        for b in blocks:
            node = self._by_block.get(b)
            if node is not None:
                out.extend(self._drop_subtree(node))
        return out

    def _drop_subtree(self, node):
        """Detach ``node`` and unregister its subtree (a child run's K/V
        means something only under its parent's context): host-resident
        nodes and retained host copies drop through
        ``host_drop_hook``.  Returns the parked device blocks among
        them, now unreferenced, for the caller to reclaim."""
        self._detach(node)
        out = []
        stack = [node]
        while stack:
            d = stack.pop()
            if d.tier == "host":
                self._by_host.pop(d.block, None)
                self._drop_host_handle(d.block)
            else:
                self._by_block.pop(d.block, None)
                self._drop_host_handle(d.host)
                d.host = None
                if self._parked.pop(d.block, None) is not None:
                    out.append(d.block)
            stack.extend(d.children.values())
            d.children = {}
        return out

    def evict(self, n):
        """Evict at least ``n`` parked blocks (fewer if the pool runs
        dry); returns their ids for the caller to `reclaim`."""
        out = []
        while len(out) < int(n) and self._parked:
            out.extend(self._evict_one())
        return out

    def clear(self):
        """Drop every cached prefix (the pool-rebuild recovery path:
        the device blocks the tree points at no longer exist).  Host
        references drop too — the owner clears the tier itself (one
        `HostBlockTier.clear`, not a hook storm)."""
        self._root = _PrefixNode(None, None, None)
        self._by_block.clear()
        self._by_host.clear()
        self._parked.clear()
