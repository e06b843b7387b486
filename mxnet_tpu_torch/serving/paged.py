"""Host-side block accounting for the paged K/V cache.

A port of `BlockAllocator`, `pool_bytes` and `TRASH_BLOCK` from
`mxnet_tpu/serving/paged.py` (the port keeps its own copy rather than
import that package).  The device pool is
`(num_layers, 2, n_blocks, block_size, embed)`; a sequence holds
ceil(tokens / block_size) blocks, named in its block table.  Block 0 is
the TRASH block: padding rows and the unallocated tail of every table
point at it, so gathers stay in bounds at fixed shapes and padding
scatters land where no sequence reads.  It is never handed out.

Without the prefix cache (a later slice) every block has exactly one
holder, so the JAX allocator's reference counts and its split of a free
into `release` and `reclaim` are not needed yet: a block is free or held,
and `free` hands it straight back.  Allocation order is the JAX one, so
both engines hand out the same block ids.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["TRASH_BLOCK", "pool_bytes", "BlockAllocator"]

TRASH_BLOCK = 0


def pool_bytes(num_layers, n_blocks, block_size, num_embed, itemsize=4):
    """Device bytes of the paged K/V pool
    `(num_layers, 2, n_blocks, block_size, num_embed)`."""
    return (int(num_layers) * 2 * int(n_blocks) * int(block_size)
            * int(num_embed) * int(itemsize))


class BlockAllocator:
    """Free list over the device block pool (ids 1..n-1).

    A usable block is free (on the free list) or held.  Every wrong
    transition raises: a double free or a trash free would let two
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
        self._free = list(range(self.n_blocks - 1, TRASH_BLOCK, -1))
        self._held = set()

    @property
    def capacity(self):
        """Usable blocks (pool minus the trash block)."""
        return self.n_blocks - 1

    @property
    def free_blocks(self):
        return len(self._free)

    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache rows."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n):
        """``n`` fresh block ids, or None when the free list cannot serve
        them.  Never partial."""
        n = int(n)
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        blocks = self._free[-n:]
        del self._free[-n:]
        self._held.update(blocks)
        return list(reversed(blocks))

    def free(self, blocks):
        """Return held blocks to the free list.  Freeing the trash block
        or a block that is not held raises."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise MXNetError("BlockAllocator: freeing the trash block")
            if b not in self._held:
                raise MXNetError(
                    "BlockAllocator: double free of block %d" % b)
            self._held.remove(b)
            self._free.append(b)
