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
requests.  The JAX package's host-DRAM tier below the index (spill,
restore) is not ported: an evicted block is simply forgotten.

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
    """One cached full-block token run: ``key`` is the exact block_size-
    token tuple, ``block`` the device block holding its K/V, and the
    parent chain spells the whole prefix."""

    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}


class PrefixCache:
    """Block-aligned radix index over cached K/V prefixes.

    Keys are the exact token tuples of FULL blocks, never hashes: a hash
    collision would alias one prompt's K/V into another's attention.
    Only full blocks take part, since a partly written block's tail is
    garbage.

    The engine `insert`s a sequence's blocks as they fill (eagerly, so a
    concurrent request can share a block its writer still holds; the
    writer's copy-on-write guards the block it writes), `lookup`s the
    longest cached prefix at admission, `park`s registered blocks whose
    refcount reaches zero, and `evict`s parked blocks, oldest first with
    leaves before roots, only under allocation pressure or past
    ``pool_cap`` (< 0: no cap).
    """

    def __init__(self, block_size, pool_cap=-1):
        self.block_size = int(block_size)
        self.pool_cap = int(pool_cap)
        self.clear()

    @property
    def cached_blocks(self):
        """Registered blocks (live + parked)."""
        return len(self._by_block)

    @property
    def parked_count(self):
        """Refcount-0 blocks retained for reuse (the LRU pool)."""
        return len(self._parked)

    def _key(self, tokens, i):
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def lookup_plan(self, tokens):
        """``(blocks, [])``: the block ids of the longest cached
        full-block prefix of ``tokens``, and the host-resident run that
        would follow them, always empty here (no host tier).  Moves the
        matched parked path to the most-recent end of the eviction
        order.  The caller must `acquire` the blocks before anything
        that could evict (a parked match stays parked until acquired)."""
        blocks = []
        node = self._root
        for i in range(len(tokens) // self.block_size):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            blocks.append(child.block)
            node = child
        while node is not self._root:
            if node.block in self._parked:
                self._parked.move_to_end(node.block)
            node = node.parent
        return blocks, []

    def lookup(self, tokens):
        """Block ids of the longest cached full-block prefix of
        ``tokens``."""
        return self.lookup_plan(tokens)[0]

    def insert(self, tokens, blocks, n_full):
        """Register the first ``n_full`` blocks of a sequence (its full
        blocks) along the tree path of ``tokens``.  A run already cached
        under another block keeps the existing copy (the walk goes on
        through it, so deeper runs still register); a run cached under
        the same block is a no-op; a block already registered elsewhere
        stops the walk (one block, one tree position).  Returns the
        number of newly registered blocks."""
        node = self._root
        added = 0
        for i in range(min(int(n_full), len(blocks))):
            key = self._key(tokens, i)
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._by_block:
                    break
                child = _PrefixNode(key, b, node)
                node.children[key] = child
                self._by_block[b] = child
                added += 1
            node = child
        return added

    def contains(self, block):
        return block in self._by_block

    def park(self, block):
        """A registered block's refcount reached zero: retain it in the
        LRU pool.  Returns the blocks evicted to honour ``pool_cap`` (the
        caller reclaims them), or None for an unregistered block (the
        caller frees it directly)."""
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
        """Blocks re-acquired through a prefix hit leave the LRU pool."""
        for b in blocks:
            self._parked.pop(b, None)

    def _evict_one(self):
        """Evict the oldest parked leaf.  A parked node's children are
        parked too (a live child would mean a live holder of the whole
        prefix), so a parked leaf exists whenever the pool is non-empty;
        taking leaves first keeps prefix roots, the shareable part, alive
        longest.  Returns the evicted block ids."""
        for b, node in self._parked.items():
            if not node.children:
                del self._parked[b]
                self._detach(node)
                return [b]
        # unreachable while the parked-subtree invariant holds: take the
        # oldest anyway, with its whole subtree, rather than loop
        b, node = next(iter(self._parked.items()))
        return self._drop_subtree(node)

    def _detach(self, node):
        self._by_block.pop(node.block, None)
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        node.parent = None

    def _drop_subtree(self, node):
        """Detach ``node`` and unregister its subtree (a child run's K/V
        means something only under its parent's context); returns the
        parked blocks among them, now unreferenced."""
        self._detach(node)
        out = []
        stack = [node]
        while stack:
            d = stack.pop()
            self._by_block.pop(d.block, None)
            if self._parked.pop(d.block, None) is not None:
                out.append(d.block)
            stack.extend(d.children.values())
            d.children = {}
        return out

    def invalidate(self, blocks):
        """Unregister the nodes backing ``blocks`` and their subtrees.
        Live holders keep their table entries (refcounts are the
        allocator's business); the runs just stop being findable.
        Returns the parked blocks detached, for the caller to reclaim."""
        out = []
        for b in blocks:
            node = self._by_block.get(b)
            if node is not None:
                out.extend(self._drop_subtree(node))
        return out

    def evict(self, n):
        """Evict at least ``n`` parked blocks (fewer if the pool runs
        dry); returns their ids for the caller to `reclaim`."""
        out = []
        while len(out) < int(n) and self._parked:
            out.extend(self._evict_one())
        return out

    def clear(self):
        """Drop every cached prefix."""
        self._root = _PrefixNode(None, None, None)
        self._by_block = {}               # block -> node
        self._parked = OrderedDict()      # block -> node, oldest first
