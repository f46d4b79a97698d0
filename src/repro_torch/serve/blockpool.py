"""Fixed-size KV-cache block allocator for the paged serving scheduler.

The device-resident cache pool is a ``(n_blocks, block_size, ...)`` array
per attention cache leaf; this module owns the HOST-side bookkeeping over
its block ids: a LIFO free list (reuse-warm blocks first), per-block
reference counts, and all-or-nothing multi-block allocation.  Ref counts
let the prefix cache pin one block under several requests' tables:
``acquire`` is the ONLY way a block enters a second table, and ``free``
drops one owner at a time.

Cached blocks (``mark_cached`` — the prefix cache registers every prompt
block it indexes) get a third state beyond free/live: when their refcount
reaches zero they park in a **cached-free** tier instead of rejoining the
free list — their device contents stay valid for future prefix hits, and
``acquire`` revives them at refcount 1.  ``alloc`` reclaims cached-free
capacity through the registered ``reclaimer`` (LRU trie eviction in
``serve/prefixcache.py``) BEFORE reporting exhaustion, so cached-but-idle
blocks are always spent before the scheduler preempts a live request.

Ids here are LOGICAL (0..n_blocks-1).  The scheduler maps them to physical
pool rows with a +1 shift: physical row 0 is the reserved trash block that
zeroed block-table rows (evicted slots) write into, so "free + live +
cached-free == n_blocks" stays exact and the allocator never needs to know
about trash.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Set


class BlockPool:
    """Free-list allocator over ``n_blocks`` token blocks of ``block_size``."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"need n_blocks >= 1 and block_size >= 1, got {n_blocks}/{block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs: List[int] = [0] * self.n_blocks
        self._cached: Set[int] = set()
        self._reclaim: Optional[Callable[[int], int]] = None
        self._n_live = 0  # O(1) mirror of sum(refs > 0): alloc touches it per block
        self.peak_live = 0
        self.total_allocs = 0  # cumulative blocks handed out (bench: prefix savings)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Blocks with at least one owner (cached-free blocks are not live)."""
        return self._n_live

    @property
    def n_cached_free(self) -> int:
        """Blocks parked in the cached-free tier: zero owners, contents indexed."""
        return sum(1 for bid in self._cached if self._refs[bid] == 0)

    def occupancy(self) -> dict:
        """Point-in-time occupancy snapshot for telemetry (DESIGN.md §13):
        free/live/cached-free partition (sums to ``n_blocks``), plus the
        cumulative peak and allocation counters."""
        return {
            "n_blocks": self.n_blocks,
            "free": self.n_free,
            "live": self.n_live,
            "cached_free": self.n_cached_free,
            "peak_live": self.peak_live,
            "total_allocs": self.total_allocs,
        }

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def is_cached(self, bid: int) -> bool:
        return bid in self._cached

    def set_reclaimer(self, fn: Optional[Callable[[int], int]]) -> None:
        """``fn(n)`` must try to move >= n cached-free blocks back to the free
        list (via ``uncache``) and return how many it released."""
        self._reclaim = fn

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or None (all-or-nothing: a partial
        grab under pressure would deadlock two growing requests).  A short
        free list asks the reclaimer to evict cached-free blocks FIRST, so
        the scheduler only sees exhaustion (-> preemption) once the prefix
        cache holds nothing idle."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) and self._reclaim is not None:
            self._reclaim(n - len(self._free))
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for bid in out:
            self._refs[bid] = 1
        self._n_live += n
        self.total_allocs += n
        self.peak_live = max(self.peak_live, self._n_live)
        return out

    def acquire(self, bid: int) -> None:
        """Pin a block under one more owner (prefix-cache sharing).  Live
        blocks gain a reference; a cached-free block revives to refcount 1.
        The ONLY legal way a block id enters a second table — ``check``
        enforces that every table reference is backed by one refcount."""
        if self._refs[bid] == 0:
            if bid not in self._cached:
                raise ValueError(f"acquire of free uncached block {bid}")
            self._refs[bid] = 1
            self._n_live += 1
            self.peak_live = max(self.peak_live, self._n_live)
        else:
            self._refs[bid] += 1

    def free(self, bid: int) -> None:
        """Drop one reference; at zero the block rejoins the free list, or
        parks in the cached-free tier when the prefix cache indexes it."""
        if self._refs[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._n_live -= 1
            if bid not in self._cached:
                self._free.append(bid)

    def free_all(self, bids: List[int]) -> None:
        """Return a whole block table (eviction / preemption)."""
        for bid in bids:
            self.free(bid)

    def mark_cached(self, bid: int) -> None:
        """Register a live block's contents as prefix-cache indexed: when its
        refcount later hits zero it parks instead of being recycled."""
        if self._refs[bid] <= 0:
            raise ValueError(f"mark_cached on free block {bid}")
        self._cached.add(bid)

    def uncache(self, bid: int) -> None:
        """Drop the cache pin (trie eviction): a cached-free block rejoins
        the free list; a live block simply loses its parking ticket."""
        if bid not in self._cached:
            raise ValueError(f"uncache of uncached block {bid}")
        self._cached.discard(bid)
        if self._refs[bid] == 0:
            self._free.append(bid)

    def check(self, tables: Optional[Iterable[Sequence[int]]] = None) -> None:
        """Invariant audit (tests): every id is exactly one of free, live, or
        cached-free, and the free list holds no duplicates.

        With ``tables`` (the live block tables), additionally assert that
        every referenced block is live and that its refcount equals the
        number of tables holding it — a block appearing in two tables with
        refcount 1 means it was shared WITHOUT ``acquire``, the aliasing bug
        the prefix cache must never introduce."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError(f"free list duplicates: {sorted(self._free)}")
        for bid in self._free:
            if self._refs[bid] != 0:
                raise AssertionError(f"block {bid} free with refcount {self._refs[bid]}")
            if bid in self._cached:
                raise AssertionError(f"block {bid} on the free list while cached")
        live = sum(1 for r in self._refs if r > 0)
        if live != self._n_live:
            raise AssertionError(f"live counter drift: {self._n_live} != {live}")
        parked = self.n_cached_free
        if live + parked + len(self._free) != self.n_blocks:
            raise AssertionError(
                f"leak: {live} live + {parked} cached-free + {len(self._free)} free "
                f"!= {self.n_blocks}"
            )
        if tables is not None:
            counts = [0] * self.n_blocks
            for table in tables:
                for bid in table:
                    counts[bid] += 1
            for bid, n in enumerate(counts):
                if n > 0 and self._refs[bid] < 1:
                    raise AssertionError(f"block {bid} in {n} live tables with refcount 0")
                if n != self._refs[bid]:
                    raise AssertionError(
                        f"block {bid}: refcount {self._refs[bid]} != {n} table references "
                        "(shared without acquire, or leaked reference)"
                    )
