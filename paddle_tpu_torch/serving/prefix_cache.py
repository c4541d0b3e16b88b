"""Radix prefix cache (a copy of `paddle_tpu/serving/prefix_cache.py`).

Shared prompt prefixes prefill once: prefill KV is kept keyed by the
token-id prefix tree and each request reuses the longest cached prefix
(RadixAttention, SGLang, Zheng et al. 2023). `RadixPrefixCache` retains
whole pool slots (the JAX package's row `SlotPool`, which the port does
not have: the paged engine refuses it); `PagedPrefixCache` retains
pages of the paged pool (`PageHold`s), which every request that hits
attaches read-only.

Structure: a compressed radix trie over token ids. Only nodes created
by an insertion own a retained resource; edge splits create structural
nodes. A lookup walks the prompt and returns the deepest owning node
whose root path shares the longest prefix with the prompt.

Lifecycle:
- `insert(tokens, slot)` at request retirement retains the prompt's KV
  (a slot, or in paged mode a hold over the slot's full pages, after
  which the slot is always freed). Nothing is retained when the prefix
  is already covered or no budget can be freed.
- `acquire`/`release` pin a node for the lifetime of a request admitted
  off it: pinned nodes are never evicted.
- Eviction is LRU over zero-ref owning nodes under the budget
  (`budget_slots`, or in paged mode `budget_pages` = `fraction *
  (num_pages - 1)`, leaving one slot's worth of pages to decode).

The key is the token prefix alone: prefill KV does not depend on the
sampling parameters, so greedy and sampled requests share entries.

Weight versions: entries are tagged with the `weight_version` that
produced them; `set_version` moves the cache forward without flushing —
stale entries stop matching lookups and are evicted lazily (on the
lookup that walks past them, and first under eviction pressure). A
rollback re-validates the surviving entries.

Namespaces: `lookup` and `insert` take a hashable `namespace` (the
engine passes `(adapter_id, adapter_version)` for adapter requests,
None for base ones). Each namespace has its own trie root, so two
adapters never share a prefix; budget, LRU and pinning stay global.

Observability (the JAX cache's): `paddle_serving_prefix_hits_total`,
`_misses_total`, `_tokens_reused_total`, `_inserts_total`,
`_evictions_total`, `_stale_evictions_total` and the
`paddle_serving_prefix_retained_slots` gauge, and a `prefix_evict` event
per reclaimed entry; `snapshot_all()` is the flight recorder's
`prefix_cache.json`.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

from .. import observability as _obs


# live caches, for flight-recorder bundles (prefix_cache.json)
_live_caches: 'weakref.WeakSet' = weakref.WeakSet()


def snapshot_all() -> List[dict]:
    """State of every live prefix cache (flight-recorder hook)."""
    return [c.snapshot() for c in list(_live_caches)]


class _Node:
    """One radix-trie node. `edge` is the token run from the parent;
    `slot`/`kv_len`/`version` are set only on owning nodes
    (kv_len == depth; version is the weight version whose prefill KV
    the retained slot holds)."""

    __slots__ = ('edge', 'children', 'parent', 'slot', 'kv_len', 'refs',
                 'last_use', 'version')

    def __init__(self, edge: Tuple[int, ...], parent: Optional['_Node']):
        self.edge = edge
        self.children: Dict[int, '_Node'] = {}
        self.parent = parent
        self.slot: Optional[int] = None
        self.kv_len = 0
        self.refs = 0
        self.last_use = 0
        self.version = 0


def _common(a: Tuple[int, ...], b: List[int], off: int) -> int:
    """Length of the common prefix of `a` and `b[off:]`."""
    n = min(len(a), len(b) - off)
    i = 0
    while i < n and a[i] == b[off + i]:
        i += 1
    return i


class RadixPrefixCache:
    """Token-prefix -> retained KV slot, LRU under a pool-fraction
    budget, with per-node ref-count pinning.

    Args:
        pool: the `SlotPool` whose slots are retained (evictions free
            straight back into it).
        fraction: max share of the pool the cache may pin as retained
            prefixes (budget_slots = int(fraction * num_slots); at
            least one slot is always left to the pool).
        min_tokens: don't retain prompts shorter than this (a 2-token
            prefix is cheaper to recompute than a slot is worth).
    """

    def __init__(self, pool, fraction: float = 0.5, min_tokens: int = 1):
        if not 0.0 < fraction <= 1.0:
            raise ValueError('fraction must be in (0, 1]')
        self.pool = pool
        self.budget_slots = min(int(fraction * pool.num_slots),
                                pool.num_slots - 1)
        self.min_tokens = max(int(min_tokens), 1)
        self._root = _Node((), None)
        # namespace key -> that namespace's own trie root (the default
        # None namespace is self._root); owners/budget/LRU stay global
        self._ns_roots: Dict = {}
        self._owners: set = set()
        self._tick = 0
        # the weight version CURRENT entries belong to; owners tagged
        # with any other version are stale (never served, lazily freed)
        self.version = 0
        self._counts = {'hits': 0, 'misses': 0, 'inserts': 0,
                        'evictions': 0, 'tokens_reused': 0,
                        'stale_evictions': 0}
        self._init_metrics()
        _live_caches.add(self)

    def _init_metrics(self):
        reg = _obs.get_registry()
        self._m_hits = reg.counter(
            'paddle_serving_prefix_hits_total',
            'submissions served a cached prefix')
        self._m_misses = reg.counter(
            'paddle_serving_prefix_misses_total',
            'submissions with no usable cached prefix')
        self._m_reused = reg.counter(
            'paddle_serving_prefix_tokens_reused_total',
            'prompt tokens whose prefill was skipped via the cache')
        self._m_inserts = reg.counter(
            'paddle_serving_prefix_inserts_total',
            'prefixes retained at retirement')
        self._m_evictions = reg.counter(
            'paddle_serving_prefix_evictions_total',
            'retained prefixes evicted (LRU / pool pressure)')
        self._m_stale_evictions = reg.counter(
            'paddle_serving_prefix_stale_evictions_total',
            'old-weight-version prefixes lazily reclaimed after a swap')
        self._m_retained = reg.gauge(
            'paddle_serving_prefix_retained_slots',
            'pool slots currently pinned by cached prefixes')
        if _obs.enabled():
            self._m_retained.set(0)


    # -- bookkeeping --------------------------------------------------------
    @property
    def retained_count(self) -> int:
        return len(self._owners)

    @property
    def reclaimable_count(self) -> int:
        """Owning nodes evictable right now (zero refs)."""
        return sum(1 for n in self._owners if n.refs == 0)

    def _touch(self, node: _Node):
        self._tick += 1
        node.last_use = self._tick

    def _ns_root(self, namespace) -> _Node:
        """The trie root serving `namespace` (created on first use; an
        empty namespace root is a few-hundred-byte dict entry, so stale
        (adapter, version) namespaces cost nothing once their owners
        are evicted)."""
        if namespace is None:
            return self._root
        root = self._ns_roots.get(namespace)
        if root is None:
            root = self._ns_roots[namespace] = _Node((), None)
        return root

    # -- weight versioning --------------------------------------------------
    def set_version(self, version: int):
        """Move the cache to a new weight version (the engine calls this
        from `swap_weights`). NO flush happens here: entries tagged with
        other versions become stale — unmatchable by lookups — and are
        reclaimed lazily (lookup walks, eviction pressure), so a swap
        never stalls live traffic behind a wholesale invalidation. A
        later `set_version` back to a previous version (rollback)
        re-validates that version's surviving entries."""
        self.version = int(version)

    @property
    def stale_count(self) -> int:
        """Retained entries whose version is not current (pending lazy
        reclamation; they never serve lookups)."""
        return sum(1 for n in self._owners if n.version != self.version)

    # -- lookup -------------------------------------------------------------
    def _subtree_owner(self, node: _Node,
                       reclaim_stale: bool = False) -> Optional[_Node]:
        """Most-recently-used CURRENT-version slot-owning node at/under
        `node`. Any such node works: its retained KV rows cover its
        whole root path, so the first `matched` of them are exactly the
        querying prompt's prefix KV. With `reclaim_stale`, unpinned
        stale (old-weight-version) owners found on the walk are freed —
        the lazy swap-invalidation path: no wholesale flush, the trie
        sheds old-version KV as traffic actually touches its subtrees
        (a full-miss lookup sweeps nothing, so a later rollback still
        finds its survivors)."""
        best, stack, stale = None, [node], []
        while stack:
            n = stack.pop()
            if n.slot is not None:
                if n.version != self.version:
                    if reclaim_stale and n.refs == 0:
                        stale.append(n)
                elif best is None or n.last_use > best.last_use:
                    best = n
            stack.extend(n.children.values())
        for n in stale:
            self._evict_node(n, stale=True)
        return best

    def lookup(self, tokens,
               namespace=None) -> Tuple[Optional[_Node], int]:
        """Longest common prefix between `tokens` and ANY cached entry
        IN `namespace`: (node, matched_len), or (None, 0). The matched
        length is the common-prefix length — it may be shorter than the
        owning node's own kv_len (a cached "system prompt + suffix A"
        serves a "system prompt + suffix B" request for the shared
        prefix; the stale A-rows above are overwritten/masked). A hit
        refreshes the node's LRU position."""
        tokens = list(tokens)
        root = self._ns_root(namespace)
        node, depth = root, 0
        deepest, deepest_len = root, 0   # divergence point
        best_exact: Tuple[Optional[_Node], int] = (None, 0)
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                break
            m = _common(child.edge, tokens, depth)
            if m < len(child.edge):
                if m > 0:          # diverges mid-edge: the child's
                    deepest, deepest_len = child, depth + m
                break              # subtree still shares depth+m tokens
            depth += m
            node = child
            deepest, deepest_len = node, depth
            if node.slot is not None and node.version == self.version:
                best_exact = (node, depth)
        hit = self._subtree_owner(deepest,
                                  reclaim_stale=deepest_len > 0)
        if hit is not None and deepest_len > best_exact[1]:
            best = (hit, deepest_len)
        else:
            best = best_exact
        if best[0] is not None and best[1] > 0:
            self._touch(best[0])
            self._counts['hits'] += 1
            self._counts['tokens_reused'] += best[1]
            if _obs.enabled():
                self._m_hits.inc()
                self._m_reused.inc(best[1])
            return best
        self._counts['misses'] += 1
        if _obs.enabled():
            self._m_misses.inc()
        return (None, 0)

    # -- pinning ------------------------------------------------------------
    def acquire(self, node: _Node):
        """Pin `node` for the lifetime of a request admitted off it
        (pinned nodes survive every eviction path)."""
        node.refs += 1

    def release(self, node: _Node):
        if node.refs <= 0:
            raise RuntimeError('prefix node released more than acquired')
        node.refs -= 1

    # -- resource hooks (row-slot vs paged-hold retention) ------------------
    def _release_entry(self, resource) -> None:
        """Return a retained resource to the pool. Base: the resource IS
        a slot index. PagedPrefixCache overrides with release_hold."""
        self.pool.free(resource)

    def _entry_repr(self, resource) -> int:
        """JSON-safe scalar for events/snapshots (`slot` fields). Base:
        the slot index itself; paged entries report -1 (they retain
        pages, not a slot)."""
        return int(resource)

    def _entry_pages(self, resource) -> int:
        """Pages pinned by a retained resource (0 in row mode — budget
        accounting there is per-slot)."""
        return 0

    def _needs_eviction(self, incoming) -> bool:
        """True while adopting `incoming` would leave retention over
        budget. Base budget: retained SLOTS."""
        return len(self._owners) >= self.budget_slots

    # -- insertion ----------------------------------------------------------
    def insert(self, tokens, slot: int, namespace=None) -> bool:
        """Retain `slot` (whose rows [0, len(tokens)) hold the prefill KV
        of `tokens`) as a cached prefix under `namespace`. Returns True
        when the cache ADOPTED the slot — the caller must NOT free it —
        and False when the caller keeps it (already covered / under
        min_tokens / budget exhausted by pinned entries)."""
        if self.budget_slots < 1:
            return False
        return self._insert_resource(tokens, int(slot), namespace)

    def _insert_resource(self, tokens, resource, namespace=None) -> bool:
        """The trie half of insert: walk/split to the prompt's node and
        adopt `resource` as its retained entry. Shared by row mode
        (resource = slot index) and paged mode (resource = PageHold)."""
        tokens = list(tokens)
        if len(tokens) < self.min_tokens:
            return False
        node, depth = self._ns_root(namespace), 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                new = _Node(tuple(tokens[depth:]), node)
                node.children[tokens[depth]] = new
                node, depth = new, len(tokens)
                break
            m = _common(child.edge, tokens, depth)
            if m == len(child.edge):
                node, depth = child, depth + m
                continue
            # split the edge at m: structural midpoint node
            mid = _Node(child.edge[:m], node)
            mid.children[child.edge[m]] = child
            node.children[tokens[depth]] = mid
            child.edge = child.edge[m:]
            child.parent = mid
            node, depth = mid, depth + m
        if node.slot is not None and node.version != self.version:
            # this exact prefix is retained under an OLD weight version:
            # the fresh KV supersedes it (a pinned stale owner — a
            # pre-swap request still decoding off it — keeps its slot;
            # the caller keeps the new one)
            if node.refs > 0:
                return False
            self._evict_node(node, stale=True, prune=False)
        covering = self._subtree_owner(node)
        if covering is not None:
            # some retained CURRENT-version entry already extends (or
            # equals) this prompt, so its rows already serve this
            # prefix: refresh it rather than spending a second slot
            self._touch(covering)
            return False
        while self._needs_eviction(resource):
            if not self.evict_lru():
                return False        # everything is pinned
        node.slot = resource
        node.kv_len = len(tokens)
        node.version = self.version
        self._owners.add(node)
        self._touch(node)
        self._counts['inserts'] += 1
        if _obs.enabled():
            self._m_inserts.inc()
            self._m_retained.set(len(self._owners))
        return True

    # -- eviction -----------------------------------------------------------
    def _evict_node(self, victim: _Node, stale: bool = False,
                    prune: bool = True) -> None:
        """Free `victim`'s retained slot back into the pool and drop it
        from the owner set. `prune=False` keeps the (now structural)
        node in the trie — the insert path re-owns it in place."""
        slot, kv_len = self._entry_repr(victim.slot), victim.kv_len
        self._release_entry(victim.slot)
        victim.slot = None
        victim.kv_len = 0
        self._owners.discard(victim)
        if prune:
            # prune now-empty leaves upward (structural nodes with
            # children stay: they still route longer retained paths)
            n = victim
            while (n.parent is not None and n.slot is None
                   and not n.children):
                del n.parent.children[n.edge[0]]
                n = n.parent
        self._counts['evictions'] += 1
        if stale:
            self._counts['stale_evictions'] += 1
        if _obs.enabled():
            self._m_evictions.inc()
            if stale:
                self._m_stale_evictions.inc()
            self._m_retained.set(len(self._owners))
        _obs.emit('prefix_evict', slot=slot, kv_len=kv_len, stale=stale,
                  retained=len(self._owners))

    def evict_lru(self) -> bool:
        """Free one ZERO-REF retained prefix back into the pool: stale
        (old-weight-version) entries go first — they can never serve a
        lookup again — then least-recently-used current entries. False
        when every entry is pinned (or empty)."""
        cands = [n for n in self._owners if n.refs == 0]
        if not cands:
            return False
        victim = min(cands, key=lambda n: (n.version == self.version,
                                           n.last_use))
        self._evict_node(victim, stale=victim.version != self.version)
        return True

    def clear(self, force: bool = False):
        """Evict every unpinned entry (tests / manual reset).
        `force=True` drops PINNED entries too — the pool-recovery path
        after a donated decode program failed mid-call, where every
        retained row is already invalid. Pins are left intact: the
        failing requests release them during their own teardown, and a
        released node that was force-evicted is simply unowned.
        Entries go least recently used first: the JAX cache walks its
        owner set, whose order follows object ids, and a fixed order
        keeps the pool's free list, so which pages later requests reuse,
        the same from run to run (an int8 page requantizes the stale rows
        a reused page still holds with its live ones)."""
        if force:
            for n in sorted(self._owners, key=lambda n: n.last_use):
                self._evict_node(n)
            return
        while self.evict_lru():
            pass

    # -- introspection ------------------------------------------------------
    def _node_count(self) -> int:
        roots = [self._root, *self._ns_roots.values()]
        n, stack = 0, list(roots)
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n - len(roots)       # roots are structural

    def stats(self) -> dict:
        return {
            'budget_slots': self.budget_slots,
            'retained_slots': len(self._owners),
            'pinned': sum(1 for n in self._owners if n.refs > 0),
            'nodes': self._node_count(),
            'namespaces': len(self._ns_roots),
            'weight_version': self.version,
            'stale_slots': self.stale_count,
            **self._counts,
        }

    def snapshot(self) -> dict:
        """Flight-recorder view: stats + the retained prefix inventory
        (lengths + pin state, NOT token contents — prompts are user
        data and postmortem bundles travel)."""
        return {
            **self.stats(),
            'entries': sorted(
                ({'kv_len': n.kv_len, 'slot': self._entry_repr(n.slot),
                  'refs': n.refs, 'pages': self._entry_pages(n.slot),
                  'last_use': n.last_use, 'version': n.version}
                 for n in self._owners),
                key=lambda e: -e['last_use']),
        }


class PagedPrefixCache(RadixPrefixCache):
    """Radix prefix cache over a `PagedSlotPool`: retention pins PAGES,
    not slots — the tentpole difference. At retirement the cache takes a
    `PageHold` over the prompt's full pages and the SLOT always goes
    back to the pool (insert never adopts it); on a hit the engine
    attaches the held page ids into the new request's page table
    read-only, so a shared system prompt costs its pages ONCE across
    every live request plus the cache — vs once per retained slot in row
    mode. Budget is counted in PAGES (`fraction * num_pages`); eviction
    stays LRU-over-zero-ref with stale-version preference, and releasing
    a hold returns its pages straight to the pool free list."""

    def __init__(self, pool, fraction: float = 0.5, min_tokens: int = 1):
        super().__init__(pool, fraction, min_tokens)
        # pages, not slots: leave at least one slot's worth for decode
        self.budget_pages = min(
            int(fraction * (pool.num_pages - 1)),
            pool.num_pages - 1 - pool.pages_per_slot)
        self._held_pages = 0

    # -- resource hooks ----------------------------------------------------
    def _release_entry(self, resource) -> None:
        self._held_pages -= len(resource.pages)
        self.pool.release_hold(resource)

    def _entry_repr(self, resource) -> int:
        return -1                      # pages retained, no slot

    def _entry_pages(self, resource) -> int:
        return len(resource.pages)

    def _needs_eviction(self, incoming) -> bool:
        return (self._held_pages + len(incoming.pages)
                > self.budget_pages)

    @property
    def held_pages(self) -> int:
        return self._held_pages

    @property
    def reclaimable_pages(self) -> int:
        """Pages in zero-ref holds (releasable on pool pressure)."""
        return sum(len(n.slot.pages) for n in self._owners
                   if n.refs == 0)

    def insert(self, tokens, slot: int, namespace=None) -> bool:
        """Pin the prompt's full pages as a PageHold and retain that.
        ALWAYS returns False: the slot itself is never adopted — the
        engine frees it, and the held pages survive the free at
        refs >= 1."""
        tokens = list(tokens)
        if len(tokens) < self.min_tokens or self.budget_pages < 1:
            return False
        hold = self.pool.hold_pages(slot, len(tokens))
        if hold is None:               # no full page covered
            return False
        adopted = self._insert_resource(tokens, hold, namespace)
        if adopted:
            self._held_pages += len(hold.pages)
        else:
            self.pool.release_hold(hold)
        return False

    def stats(self) -> dict:
        out = super().stats()
        out.update(budget_pages=self.budget_pages,
                   held_pages=self._held_pages,
                   reclaimable_pages=self.reclaimable_pages)
        return out
