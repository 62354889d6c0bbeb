"""Host-side block-table allocator for the paged KV cache.

A copy of ``repro.serve.kv_cache``.  Pure Python, so the whole
alloc/append/free lifecycle and the pool-exhaustion policy are
unit-testable without a model.  The device pool it manages is
:class:`repro_torch.models.attention.PagedKV`: a global
array of fixed-size KV blocks; this class decides WHICH block each
request's next tokens land in and hands the engine the per-request
block tables that the paged kernels dereference.

Block 0 is the reserved NULL block (never allocated): padded table
entries and dead decode lanes point there, so device code needs no
validity branches — see PagedKV's docstring.

Admission is reservation-based to stay deadlock-free: ``reserve(rid,
n_tokens)`` claims a request's WORST-CASE block count (prompt +
max_new) up front, and later ``append``/``ensure`` calls draw blocks
lazily against that claim.  A request that cannot reserve is the
engine's signal to shed or defer through the AdmissionQueue — an
admitted request can always run to completion, so the pool can never
wedge with every sequence mid-decode and no blocks left.
"""

from __future__ import annotations


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: freed blocks are reused first (test-visible)
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: dict[int, list[int]] = {}
        self._resv: dict[int, int] = {}     # rid -> blocks still claimable

    # -- accounting --------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (some may be claimed by reservations)."""
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    @property
    def reserved_blocks(self) -> int:
        """Outstanding (not yet drawn) reservation claims."""
        return sum(self._resv.values())

    @property
    def occupancy(self) -> float:
        return self.used_blocks / self.capacity

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    # -- lifecycle ---------------------------------------------------------

    def reserve(self, rid: int, n_tokens: int) -> bool:
        """Claim worst-case blocks for ``n_tokens``; False if the pool's
        unclaimed headroom can't cover it (caller sheds or defers)."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already active")
        need = self.blocks_needed(n_tokens)
        if need > len(self._free) - self.reserved_blocks:
            return False
        self._tables[rid] = []
        self._resv[rid] = need
        return True

    def append(self, rid: int) -> int | None:
        """Grow ``rid``'s table by one block; None if nothing is available.

        Draws against the request's own reservation first, then against
        unclaimed headroom (a request may overrun its estimate only if
        that doesn't eat another request's claim).
        """
        table = self._tables[rid]
        own = self._resv.get(rid, 0)
        if own > 0:
            self._resv[rid] = own - 1
        elif len(self._free) - self.reserved_blocks < 1:
            return None
        blk = self._free.pop()
        table.append(blk)
        return blk

    def ensure(self, rid: int, n_tokens: int) -> bool:
        """Grow ``rid``'s table until it covers ``n_tokens`` positions."""
        while len(self._tables[rid]) * self.block_size < n_tokens:
            if self.append(rid) is None:
                return False
        return True

    def free(self, rid: int) -> None:
        """Return ``rid``'s blocks (and any undrawn claim) to the pool."""
        self._free.extend(reversed(self._tables.pop(rid)))
        self._resv.pop(rid, None)

    # -- views -------------------------------------------------------------

    def table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def padded_table(self, rid: int, width: int) -> list[int]:
        """Fixed-width table view: owned blocks then null-block padding."""
        t = self._tables[rid]
        if len(t) > width:
            raise ValueError(f"rid {rid} owns {len(t)} blocks > width {width}")
        return t + [0] * (width - len(t))
