"""Paged KV-cache memory manager, the host side of the block pool (copy of
``deepspeed_tpu/serving/kv_pool.py``).

The dense slot pool allocates one ``n_slots x max_len`` KV region, so slot
count — i.e. concurrent users — is capped by WORST-CASE sequence length.
This module replaces that with vLLM-style paging: a fixed pool of
``n_blocks`` physical token blocks plus a per-slot block table. Everything
dynamic lives HERE, on the host (allocation, refcounts, the shared-prefix
cache); the device holds the pool and the table as tensors, and the decode
step reads the pool through the table (a gather, or the paged flash-decode
kernel walking the table itself).

Three mechanisms, one invariant set:

- **Block allocation by footprint.** A request reserves
  ``ceil((prompt + max_new - 1) / block_size)`` blocks — its actual token
  footprint — instead of a ``max_len`` window. Block 0 is the reserved
  GARBAGE block: freed slots' table rows point at it, so their dead decode
  writes can never corrupt a reallocated block.
- **Copy-on-write shared prefixes.** Full prompt blocks are
  content-addressed by an incremental SHA-256 chain over their token bytes
  (key_j commits to blocks 0..j; linear-time, collision-free in practice):
  an identical prefix maps to the SAME physical blocks,
  refcounted, and only the suffix is prefilled. Shared blocks are
  structurally read-only — a slot's write cursor starts at ``prompt_len``,
  and matching is capped at ``prompt_len - 1``, so the cursor can never
  enter a shared block. Cache entries hold their own +1 refcount and are
  evicted LRU when allocation needs the space.
- **Shed-with-reason.** A request whose footprint exceeds what the pool
  could EVER provide sheds ``no_free_blocks`` at admission; one that merely
  has to wait for running requests to free blocks stays queued (FCFS).

``stats()`` feeds ``ServingMetrics``' kv_pool block: occupancy (allocated /
allocatable blocks), internal fragmentation (1 - live tokens / allocated
token capacity), and the prefix hit rate (matched / candidate full blocks).
"""

import collections
import hashlib

from ..config.base import ConfigError

GARBAGE_BLOCK = 0


def prefix_chain_keys(prompt, block_size, limit=None):
    """``[((end, digest), end), ...]`` — one entry per full ``block_size``
    prompt block with ``end <= limit`` (default ``len(prompt)``). Keys are an
    INCREMENTAL SHA-256 chain over the token bytes (key_j digests blocks
    0..j), so key construction is linear in prompt length and a key still
    commits to the entire prefix content — two prompts share a key iff their
    prefixes collide SHA-256, i.e. never in practice.

    This is the cross-replica prefix currency: ``KVPoolManager`` content-
    addresses physical blocks with these keys, and the router's shared
    prefix index maps the SAME keys to replicas, so an identical system
    prompt routes to the replica whose pool already holds its blocks."""
    if limit is None:
        limit = len(prompt)
    out = []
    h = hashlib.sha256()
    end = block_size
    while end <= limit:
        h.update(prompt[end - block_size:end].tobytes())
        out.append(((end, h.digest()), end))
        end += block_size
    return out


class KVPoolManager:
    """Host-side allocator + prefix cache for the paged KV pool.

    Owns no device arrays: ``ServingEngine`` holds the pool/table state and
    calls back into this class for every allocation decision. All methods
    are O(blocks touched) and run on the host.
    """

    def __init__(self, cfg, n_slots, max_len):
        self.cfg = cfg
        self.block_size = int(cfg.block_size)
        if max_len % self.block_size:
            raise ConfigError(
                f"serving max_len {max_len} must be a multiple of "
                f"kv_pool.block_size {self.block_size}")
        self.blocks_per_slot = max_len // self.block_size
        auto = n_slots * self.blocks_per_slot + 1
        self.n_blocks = int(cfg.n_blocks) or auto
        if self.n_blocks < 2:
            raise ConfigError(
                f"kv_pool.n_blocks must be >= 2 (block 0 is reserved), "
                f"got {self.n_blocks}")
        self._free = collections.deque(range(1, self.n_blocks))
        self._ref = [0] * self.n_blocks
        # prefix cache: token-bytes key -> physical block id (LRU order);
        # each cached block carries its own +1 ref so it survives request
        # churn until evicted
        self._prefix = collections.OrderedDict()
        self._block_key = {}        # block id -> its cache key (if cached)
        self._slot_blocks = {}      # slot -> list of distinct block ids
        self._slot_tokens = {}      # slot -> footprint in tokens (live)
        # counters (prefix hit rate is per candidate FULL block, the unit
        # sharing actually happens at)
        self.prefix_hit_blocks = 0
        self.prefix_candidate_blocks = 0
        self.prefix_hit_requests = 0
        self.prefix_requests = 0
        self.scrubbed_blocks = 0
        self.grown_blocks = 0       # on-demand-growth allocations mid-decode
        self.preempted_requests = 0  # preempt-to-queue on pool exhaustion
        # speculative rollback: grown blocks released because every row
        # they held belonged to rejected draft candidates
        self.rolled_back_blocks = 0
        self._scrub = None          # engine-installed per-block scrub hook
        # admission-time reservations not yet consumed by a slot insert:
        # chunked prefill opens a multi-step window between can_admit and
        # insert, and a later admission must not steal the head's blocks
        self._pending = 0

    # -- capacity ----------------------------------------------------------
    @property
    def allocatable(self):
        """Blocks a single request could ever hold (garbage block excluded)."""
        return self.n_blocks - 1

    def blocks_for(self, prompt_len, max_new_tokens):
        """Footprint of a request: positions [0, prompt_len + max_new - 1)
        are written (the last sampled token is never written back)."""
        tokens = max(prompt_len + max_new_tokens - 1, 1)
        return -(-tokens // self.block_size)

    def blocks_for_prefill(self, prefill_len):
        """On-demand growth's ADMISSION footprint: only the prefilled
        positions [0, prefill_len) — decode blocks are allocated as the
        cursor advances (``reserve-as-you-decode``), so admission stops
        paying for tokens not yet generated."""
        return -(-max(prefill_len, 1) // self.block_size)

    def _evictable(self):
        """Cached prefix blocks held ONLY by the cache (ref == 1)."""
        return sum(1 for b in self._prefix.values() if self._ref[b] == 1)

    def can_allocate(self, n):
        return n + self._pending <= len(self._free) + self._evictable()

    # -- admission reservations -------------------------------------------
    def reserve(self, n):
        """Hold ``n`` blocks against future ``can_allocate`` checks until a
        slot insert consumes the reservation (chunked prefill runs between
        admission and insert; without this, a later admission or an
        on-demand growth could strand the admitted head)."""
        self._pending += int(n)

    def consume_reservation(self, n):
        """The insert that the reservation guarded is allocating now."""
        self._pending = max(self._pending - int(n), 0)

    def fits_ever(self, prompt_len, max_new_tokens):
        """False -> shed ``no_free_blocks``: even an empty pool could not
        hold this request's footprint."""
        return self.blocks_for(prompt_len, max_new_tokens) <= self.allocatable

    # -- allocation --------------------------------------------------------
    def alloc(self, n):
        """Take ``n`` free blocks (evicting LRU cached prefixes as needed).
        Returns the block ids; raises if ``can_allocate(n)`` was False."""
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            raise RuntimeError(
                f"kv_pool: asked for {n} blocks with only {len(self._free)} "
                "free and nothing evictable (caller skipped can_allocate)")
        out = [self._free.popleft() for _ in range(n)]
        for b in out:
            self._ref[b] += 1
        return out

    def _evict_one(self):
        """Drop the LRU prefix entry whose block the cache holds the LAST
        reference to (ref == 1) — evicting an entry a running slot still
        references would free nothing while destroying shareable cache
        state for good. Returns False when nothing evictable remains."""
        for key, bid in self._prefix.items():
            if self._ref[bid] == 1:
                del self._prefix[key]
                del self._block_key[bid]
                self._unref(bid)
                return True
        return False

    def _unref(self, bid):
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            if self._scrub is not None:
                self._scrub(bid)
                self.scrubbed_blocks += 1

    def release_blocks(self, block_ids):
        """Drop one reference per distinct block (early-finish / error
        unwind for blocks not yet bound to a slot)."""
        for b in dict.fromkeys(block_ids):
            if b != GARBAGE_BLOCK:
                self._unref(b)

    # -- slot binding ------------------------------------------------------
    def bind_slot(self, slot, block_ids, footprint_tokens):
        """Record ``slot`` as owning ``block_ids`` (refs were taken by
        ``alloc``/``acquire_prefix``)."""
        self._slot_blocks[slot] = list(dict.fromkeys(
            b for b in block_ids if b != GARBAGE_BLOCK))
        self._slot_tokens[slot] = int(footprint_tokens)

    def free_slot(self, slot):
        """Release every block the slot holds; a block returns to the free
        list (and is scrubbed, if configured) when its last reference —
        slot or prefix-cache — drops."""
        for b in self._slot_blocks.pop(slot, ()):
            self._unref(b)
        self._slot_tokens.pop(slot, None)

    def grow_slot(self, slot, live_tokens):
        """On-demand growth: allocate ONE more block for ``slot`` (its decode
        cursor reached the end of its bound blocks) and record it. Returns
        the physical block id; the caller must have checked
        ``can_allocate(1)`` (and preempts to the queue when it is False)."""
        bid = self.alloc(1)[0]
        self._slot_blocks[slot].append(bid)
        self._slot_tokens[slot] = int(live_tokens)
        self.grown_blocks += 1
        return bid

    def shrink_slot(self, slot, live_tokens):
        """Speculative rollback under on-demand growth: drop the slot's
        LAST bound block — it lies entirely past the rolled-back cursor,
        so every row it holds belongs to rejected draft candidates. The
        block returns to the allocator on its last-ref drop (and is
        scrubbed there when the hygiene scrub is armed); the caller must
        already have retreated the slot's table entry to the garbage
        block."""
        bid = self._slot_blocks[slot].pop()
        self._slot_tokens[slot] = int(live_tokens)
        self.rolled_back_blocks += 1
        self._unref(bid)

    def slot_block_count(self, slot):
        return len(self._slot_blocks.get(slot, ()))

    def slot_block(self, slot, j):
        """Physical block id at table column ``j`` of ``slot``."""
        return self._slot_blocks[slot][j]

    # -- shared prefixes ---------------------------------------------------
    def _candidate_keys(self, prompt, limit):
        """(key, end) per full prompt block with ``end <= limit`` (the
        module-level ``prefix_chain_keys`` chain — shared with the router's
        cross-replica prefix index so both sides speak the same keys)."""
        return prefix_chain_keys(prompt, self.block_size, limit)

    def acquire_prefix(self, prompt):
        """Longest cached prefix of ``prompt``: returns (shared_len,
        block_ids), taking one reference per matched block (so an eviction
        between admission and insert cannot dangle them). Counters feed the
        prefix_hit_rate metric."""
        if not self.cfg.prefix_cache:
            return 0, []
        # capped at prompt_len - 1 so the write cursor (>= prompt_len) can
        # never enter a matched block — COW holds structurally, no device
        # fault path needed
        cands = self._candidate_keys(prompt, len(prompt) - 1)
        if cands:
            self.prefix_requests += 1
        self.prefix_candidate_blocks += len(cands)
        blocks, shared_len = [], 0
        for key, end in cands:
            bid = self._prefix.get(key)
            if bid is None:
                break
            self._prefix.move_to_end(key)   # LRU recency
            self._ref[bid] += 1
            blocks.append(bid)
            shared_len = end
        self.prefix_hit_blocks += len(blocks)
        if blocks:
            self.prefix_hit_requests += 1
        return shared_len, blocks

    def register_prefix(self, prompt, table_blocks):
        """Content-address the request's full prompt blocks (block j is
        full iff (j+1)*block_size <= prompt_len; such blocks are never
        written after insert, so sharing them is safe). Already-cached keys
        keep their canonical block; new ones take the cache's +1 ref."""
        if not self.cfg.prefix_cache:
            return
        bs = self.block_size
        limit = min(len(prompt) // bs, len(table_blocks)) * bs
        for j, (key, _end) in enumerate(self._candidate_keys(prompt, limit)):
            if key in self._prefix:
                self._prefix.move_to_end(key)
                continue
            bid = table_blocks[j]
            if bid == GARBAGE_BLOCK or bid in self._block_key:
                continue
            self._ref[bid] += 1
            self._prefix[key] = bid
            self._block_key[bid] = key

    # -- metrics -----------------------------------------------------------
    def occupancy(self):
        """Held fraction of allocatable blocks — the cheap O(1) accessor
        the router's per-request load scoring reads; the full ``stats()``
        dict (with its per-slot scans) is for metrics emission."""
        allocatable = max(self.allocatable, 1)
        return (allocatable - len(self._free)) / allocatable

    def stats(self):
        allocatable = max(self.allocatable, 1)
        held = allocatable - len(self._free)   # slots + prefix cache
        occupancy = self.occupancy()
        live_tokens = sum(self._slot_tokens.values())
        slot_capacity = sum(len(b) for b in self._slot_blocks.values()) \
            * self.block_size
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "capacity_tokens": allocatable * self.block_size,
            "allocated_blocks": held,
            "free_blocks": len(self._free),
            "cached_prefix_blocks": len(self._prefix),
            "occupancy": round(occupancy, 4),
            # internal fragmentation of REQUEST-held blocks: reserved token
            # capacity the live footprints don't use (0 = perfectly packed)
            "fragmentation": round(1.0 - live_tokens / slot_capacity, 4)
            if slot_capacity else 0.0,
            "prefix_hit_rate": round(
                self.prefix_hit_blocks / self.prefix_candidate_blocks, 4)
            if self.prefix_candidate_blocks else 0.0,
            "prefix_hit_requests": self.prefix_hit_requests,
            "prefix_requests": self.prefix_requests,
            "scrubbed_blocks": self.scrubbed_blocks,
            "grown_blocks": self.grown_blocks,
            "preempted_requests": self.preempted_requests,
            "rolled_back_blocks": self.rolled_back_blocks,
            "reserved_blocks": self._pending,
        }
