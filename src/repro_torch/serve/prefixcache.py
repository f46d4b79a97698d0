"""Automatic prefix cache: a host-side radix index over the paged block pool
(the port's own copy of ``repro/serve/prefixcache.py``; host-only).

vLLM-style automatic prefix caching / SGLang RadixAttention, adapted to the
block-pool serving stack (DESIGN.md §7): identical prompt prefixes
(system prompts, few-shot headers) are prefilled and stored ONCE, and later
requests pin the existing blocks into their block tables at admission
instead of re-allocating and re-computing them.

Index structure.  A trie whose edges are **token-block contents**: a node
covers one pool block and is keyed, within its parent, by the tuple of
tokens written into that block.  Because a KV block's contents depend on
the ENTIRE preceding context (attention mixes every earlier position), the
block's token tuple alone is not an identity — the path from the root is:
two blocks share KV iff their token tuples AND all ancestor tuples match,
which is exactly what the trie walk checks.  Full nodes (``len(key) ==
block_size``) may have children; partially-filled nodes (a prompt's last
block) are leaves.  The whole index is namespaced by the engine's **params
fingerprint** (quantize_tree vs pack_tree artifacts produce different KV
bytes from the same tokens and must never cross-share); the pool and its
blocks live per scheduler, so the fingerprint is recorded at construction
and asserted on every operation.

Matching (``match``) walks full blocks, then scans the terminal node's
children for the longest common token prefix with the remaining prompt —
sharing may stop at a NON-block-aligned boundary, in which case the caller
copy-on-writes the partially-matched source block (scheduler: a fresh
block plus one on-device row-slice copy) before appending into it.

Eviction.  Blocks stay indexed while live; at refcount zero they park in
the pool's cached-free tier (``blockpool.mark_cached``).  ``reclaim`` —
installed as the pool's reclaimer — evicts trie nodes in LRU order (ticks
update on every match/insert touch) until enough blocks returned to the
free list, and runs from inside ``BlockPool.alloc`` BEFORE the scheduler
ever sees exhaustion: cached-but-idle blocks are always reclaimed ahead of
youngest-request preemption.  A node never outlives its ancestors' LRU
position (touching a child touches the whole path, so ``tick(parent) >=
tick(child)``), and a refcount-0 node's descendants are refcount-0 too
(attaching a child pins the whole path), so evicting the LRU node's
subtree only ever touches evictable blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.blockpool import BlockPool


@dataclasses.dataclass
class _Node:
    """One cached block: ``key`` is the token tuple written into it."""

    key: Tuple[int, ...]
    bid: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(default_factory=dict)
    tick: int = 0

    @property
    def depth(self) -> int:
        d, node = 0, self
        while node.parent is not None:
            d, node = d + 1, node.parent
        return d


def _common_prefix(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Radix index over one scheduler's ``BlockPool`` (module docstring)."""

    def __init__(self, pool: BlockPool, block_size: int, fingerprint: str):
        self.pool = pool
        self.block_size = int(block_size)
        self.fingerprint = str(fingerprint)
        self._root = _Node(key=(), bid=-1, parent=None)
        self._nodes: Dict[int, _Node] = {}  # bid -> node
        self._tick = 0
        self.stats: Dict[str, int] = dict.fromkeys(
            ("hits", "misses", "hit_tokens", "inserted_blocks", "evicted_blocks"), 0)

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        while node is not None and node is not self._root:
            node.tick = self._tick
            node = node.parent

    def match(
        self, tokens, fingerprint: str, max_match: Optional[int] = None
    ) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``tokens``: returns ``(matched,
        bids)`` where ``bids`` cover blocks 0..ceil(matched/block)-1 of the
        prompt (the last may be partially matched — the caller must COW it
        before writing).  ``max_match`` caps the usable prefix (admission
        passes ``len(tokens) - 1`` so a hit always leaves one tail token to
        prefill and sample) — stats count the CAPPED match, so they agree
        with the scheduler's prefix_* counters.  Updates LRU ticks along
        the matched path; a hit means >= 1 block-row of KV is reusable."""
        if fingerprint != self.fingerprint:
            raise ValueError(
                f"params fingerprint mismatch: cache built for {self.fingerprint}, "
                f"lookup with {fingerprint} (quantize_tree/pack_tree artifacts never cross-share)"
            )
        toks = [int(t) for t in tokens]
        cap = len(toks) if max_match is None else max(0, int(max_match))
        blk = self.block_size
        node, matched, bids = self._root, 0, []
        while matched + blk <= min(len(toks), cap):
            child = node.children.get(tuple(toks[matched : matched + blk]))
            if child is None:
                break
            node, matched = child, matched + blk
            bids.append(child.bid)
        # terminal scan: longest common token prefix against any child (full
        # or partial) — sharing may stop mid-block (COW boundary)
        rem = toks[matched:]
        best, best_child = 0, None
        for child in node.children.values():
            n = _common_prefix(child.key, rem)
            if n > best:
                best, best_child = n, child
        if best_child is not None:
            matched += best
            bids.append(best_child.bid)
            self._touch(best_child)
        elif bids:
            self._touch(node)
        matched = min(matched, cap)
        bids = bids[: -(-matched // blk) if matched else 0]
        if matched > 0:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += matched
        else:
            self.stats["misses"] += 1
        return matched, bids

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------
    def insert(self, tokens, blocks: List[int], fingerprint: str) -> None:
        """Index a just-admitted prompt's blocks: ``blocks[i]`` holds the
        KV of tokens ``[i*block, (i+1)*block)`` (the last entry partially,
        when the prompt length is not a block multiple).  Levels already
        indexed keep the EXISTING node (the new table references the shared
        block there anyway, or owns a private COW copy that is redundant to
        index twice under the same key); fresh levels register their block
        with the pool so eviction parks it instead of recycling."""
        if fingerprint != self.fingerprint:
            raise ValueError(f"params fingerprint mismatch: {self.fingerprint} vs {fingerprint}")
        toks = [int(t) for t in tokens]
        blk = self.block_size
        node = self._root
        n_full, rem = divmod(len(toks), blk)
        for i in range(n_full):
            key = tuple(toks[i * blk : (i + 1) * blk])
            child = node.children.get(key)
            if child is None:
                bid = blocks[i]
                if bid in self._nodes:  # defensive: one node per block id
                    break
                child = _Node(key=key, bid=bid, parent=node)
                node.children[key] = child
                self._nodes[bid] = child
                self.pool.mark_cached(bid)
                self.stats["inserted_blocks"] += 1
            node = child
        if rem and n_full < len(blocks):
            key = tuple(toks[n_full * blk :])
            child = node.children.get(key)
            if child is None and blocks[n_full] not in self._nodes:
                bid = blocks[n_full]
                child = _Node(key=key, bid=bid, parent=node)
                node.children[key] = child
                self._nodes[bid] = child
                self.pool.mark_cached(bid)
                self.stats["inserted_blocks"] += 1
            if child is not None:
                node = child  # touch the leaf too, or a fresh partial node
                # would sit at tick 0 and be the FIRST eviction victim
        self._touch(node)

    # ------------------------------------------------------------------
    # eviction
    # ------------------------------------------------------------------
    @property
    def n_cached_blocks(self) -> int:
        return len(self._nodes)

    def _evict_node(self, node: _Node) -> int:
        """Remove ``node`` and its (necessarily refcount-0) subtree."""
        freed = 0
        for child in list(node.children.values()):
            freed += self._evict_node(child)
        del node.parent.children[node.key]
        del self._nodes[node.bid]
        self.pool.uncache(node.bid)
        self.stats["evicted_blocks"] += 1
        return freed + 1

    def reclaim(self, n: int) -> int:
        """Evict LRU trie nodes whose blocks are cached-free until >= ``n``
        blocks returned to the pool's free list (or nothing evictable is
        left).  Installed as the pool's reclaimer: runs inside ``alloc``,
        BEFORE the scheduler's preemption path ever triggers."""
        # one scan: refcounts cannot change inside this loop, and a victim's
        # descendants are evicted with it (skip them when their turn comes)
        victims = [node for node in self._nodes.values() if self.pool.refcount(node.bid) == 0]
        # oldest tick first; ticks tie along a just-touched path, where the
        # deepest node must go first (children before ancestors)
        victims.sort(key=lambda nd: (nd.tick, -nd.depth))
        freed = 0
        for victim in victims:
            if freed >= n:
                break
            if victim.bid in self._nodes:  # not already gone with a subtree
                freed += self._evict_node(victim)
        return freed
