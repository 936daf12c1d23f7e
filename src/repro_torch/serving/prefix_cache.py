"""Content-addressed multi-tenant prefix KV cache over ``PageAllocator``.

Agent fleets re-send the same long system and tool prompts per tenant;
with the paged engine's position-addressed pools a repeated prefix does
not need a re-prefill -- the pages holding its KV can be *referenced* by
the next request.

* Token streams are hashed in page-aligned blocks into a per-tenant
  *chain*: node ``d``'s key is ``H(parent_key, tokens[d*ps:(d+1)*ps])``
  (blake2b, 16-byte digest, the block as int32 bytes), so a chain key
  commits to the whole prefix up to that block.  Tenants are isolated by
  seeding the chain at a per-namespace root; tenants listed in
  ``cross_tenant`` hash under the shared "" namespace.  The keys are the
  JAX package's byte for byte: the v3 wire ships them between engines of
  either package.
* Each full-block node owns one physical page (allocator owner tag
  ``prefix:<key>``) holding the block's KV exactly as prefill wrote it.
  Shared pages are immutable: a request only reads them through its page
  table.  The partially filled tail block holding a request's first
  decode position is never shared in place: it is copied into a private
  page at admission (copy on write), and a cold request donates a *copy*
  of its tail so later requests can hit it.
* Nodes are refcounted: one ref per engine row referencing the node plus
  one per child node (children pin parents).  LRU eviction reclaims only
  refcount-0 nodes, leaves first, so evictable pages count as free
  admission budget without a page some row addresses ever being freed.

The cache manages page identities and lifetimes only; the engine owns
the pools and performs the KV copies (``PagedEngine._copy_page``), so
this module needs no tensors and its property harness drives it against
a bare allocator.  Its invariant checks raise ``RuntimeError`` (they
keep firing under ``python -O``), as ``PageAllocator.check`` does.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

_DIGEST = 16                         # blake2b digest bytes (32 hex chars)
_MAX_TAILS = 4                       # partial-tail fanout cap per chain key


def _root_key(namespace: str) -> str:
    return hashlib.blake2b(b"prefix-root:" + namespace.encode(),
                           digest_size=_DIGEST).hexdigest()


def _child_key(parent_key: str, block: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=_DIGEST)
    h.update(bytes.fromhex(parent_key))
    h.update(np.asarray(block, np.int32).tobytes())
    return h.hexdigest()


class HashedPrefix:
    """A prompt hashed into chain keys once and probed many times: the
    chain for a (namespace, page_size) pair is computed on first use and
    memoized, so N engines of one geometry cost one hashing pass."""

    def __init__(self, tokens):
        self.tokens = np.asarray(tokens, np.int32)
        self._chains: dict[tuple, list] = {}

    def chain(self, namespace: str, page_size: int) -> list:
        """``[(chain_key, block), ...]`` for every full block."""
        memo = self._chains.get((namespace, page_size))
        if memo is None:
            key, memo = _root_key(namespace), []
            for d in range(len(self.tokens) // page_size):
                block = self.tokens[d * page_size:(d + 1) * page_size]
                key = _child_key(key, block)
                memo.append((key, block))
            self._chains[(namespace, page_size)] = memo
        return memo


@dataclass
class PrefixNode:
    """One shared block: a physical page plus its identity and lifetime.
    ``tokens`` guards against hash collisions and, for a partial tail,
    is the match material (longest common prefix)."""
    key: str                         # chain hash (hex)
    namespace: str                   # tenant namespace ("" = shared)
    depth: int                       # block index within the prefix
    page: int                        # physical page id in the engine pool
    tokens: np.ndarray               # block tokens (== page_size iff full)
    parent: str | None               # parent chain key (None at depth 0)
    partial: bool = False            # tail block (always copied on write)
    refs: int = 0                    # row references + child nodes
    stamp: int = 0                   # LRU clock at last touch


@dataclass
class PrefixStats:
    hits: int = 0                    # admissions with hit_tokens > 0
    misses: int = 0                  # admissions that found nothing
    evictions: int = 0               # pages reclaimed by LRU
    bytes_saved: int = 0             # hit_tokens * per-token KV bytes
    hit_tokens: int = 0              # total prefill tokens served shared
    inserted: int = 0                # pages donated into the cache

    def as_dict(self) -> dict:
        return dict(vars(self))


class PrefixCache:
    """Per-engine chain of refcounted immutable shared pages."""

    def __init__(self, allocator, *, page_size: int,
                 cross_tenant: tuple = (), token_bytes: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        self.cross_tenant = frozenset(cross_tenant)
        self.token_bytes = token_bytes   # per-token KV bytes (engine-set)
        self.nodes: dict[str, PrefixNode] = {}       # full blocks by key
        self.tails: dict[str, list[PrefixNode]] = {}  # partials by parent
        self.stats = PrefixStats()
        self._clock = 0
        allocator.auditors.append(self._audit)

    # -- identity -----------------------------------------------------------
    def namespace(self, tenant: str) -> str:
        return "" if tenant in self.cross_tenant else tenant

    def chain_keys(self, tenant: str, tokens) -> list[str]:
        """Chain hashes of every *full* block of ``tokens``."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        key, keys = _root_key(self.namespace(tenant)), []
        for d in range(len(tokens) // ps):
            key = _child_key(key, tokens[d * ps:(d + 1) * ps])
            keys.append(key)
        return keys

    # -- lookup -------------------------------------------------------------
    def _touch(self, node: PrefixNode):
        self._clock += 1
        node.stamp = self._clock

    def _walk(self, tenant: str, tokens) -> list[PrefixNode]:
        """The cached full-block nodes covering ``tokens`` from the root."""
        ps = self.page_size
        key, full = _root_key(self.namespace(tenant)), []
        for d in range(len(tokens) // ps):
            block = tokens[d * ps:(d + 1) * ps]
            node = self.nodes.get(_child_key(key, block))
            if node is None or not np.array_equal(node.tokens, block):
                break
            full.append(node)
            key = node.key
        return full

    def match(self, tenant: str, tokens):
        """Longest cached coverage of ``tokens``: ``(full_nodes, tail,
        hit_tokens)``.

        ``full_nodes`` may be referenced in place (after ``acquire``);
        ``tail``, if any, is a partial block whose page the caller must
        copy, contributing its longest common prefix with the remaining
        tokens to the hit.  A lookup: no stats, no refcounts, only the
        LRU stamps of what it found."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        full = self._walk(tenant, tokens)
        key = full[-1].key if full else _root_key(self.namespace(tenant))
        hit = len(full) * ps
        rest = tokens[hit:]
        tail, tail_hit = None, 0
        # partial tails hang off the deepest matched chain key; a match
        # extends coverage even mid-block (the copy's slots past the
        # match point are overwritten by the suffix prefill)
        if len(rest):
            for cand in self.tails.get(key, ()):
                n = _common_prefix(cand.tokens, rest)
                if n > tail_hit:
                    tail, tail_hit = cand, n
        for node in full + ([tail] if tail else []):
            self._touch(node)
        return full, tail, hit + tail_hit

    def hit_tokens(self, tenant: str, tokens) -> int:
        """Full-block cached coverage: the prefill tokens (and exactly
        ``hit // page_size`` pages) a warm admission would not charge."""
        return len(self._walk(tenant, np.asarray(tokens, np.int32))) \
            * self.page_size

    def hit_tokens_hashed(self, tenant: str, hashed: HashedPrefix) -> int:
        """``hit_tokens`` over precomputed digests: no hashing here
        beyond ``hashed``'s memoized pass."""
        hit = 0
        for key, block in hashed.chain(self.namespace(tenant),
                                       self.page_size):
            node = self.nodes.get(key)
            if node is None or not np.array_equal(node.tokens, block):
                break
            hit += self.page_size
        return hit

    def has_chain(self, chain: list[str]) -> bool:
        return self.lookup_chain(chain) is not None

    def lookup_chain(self, chain: list[str]) -> list[PrefixNode] | None:
        """Resolve a wire chain (v3 suffix-only migration): every key
        present and parent-linked from the root, else None."""
        nodes, parent_key = [], None
        for key in chain:
            node = self.nodes.get(key)
            if node is None or node.partial or node.parent != parent_key:
                return None
            nodes.append(node)
            parent_key = key
        return nodes

    # -- refcounts ----------------------------------------------------------
    def acquire(self, nodes):
        for n in nodes:
            n.refs += 1
            self._touch(n)

    def release(self, nodes):
        for n in nodes:
            if n.refs <= 0:
                raise RuntimeError(f"releasing unreferenced node {n.key}")
            n.refs -= 1
            self._touch(n)

    def account(self, hit_tokens: int):
        """Record one admission's outcome into the counters."""
        if hit_tokens > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += hit_tokens
            self.stats.bytes_saved += hit_tokens * self.token_bytes
        else:
            self.stats.misses += 1

    # -- insertion ----------------------------------------------------------
    def _insert(self, node: PrefixNode, parent: PrefixNode | None):
        if parent is not None:
            parent.refs += 1         # children pin parents
        self._touch(node)
        self.stats.inserted += 1
        return node

    def adopt(self, tenant: str, tokens, depth: int,
              page: int) -> PrefixNode | None:
        """Donate the full block at ``depth`` of ``tokens``: ``page``
        (which the caller owns) is retagged to the cache as a refcount-0
        node (the caller ``acquire``s it to keep referencing the page).
        None -- the caller keeps its private page -- if the block is
        already cached: moving a row onto a peer's page mid-request would
        break its bit-exactness."""
        keys = self.chain_keys(tenant, tokens)
        key = keys[depth]
        if key in self.nodes:
            return None
        parent = None
        if depth > 0:
            parent = self.nodes.get(keys[depth - 1])
            if parent is None:
                raise RuntimeError(f"chain donated out of order at depth "
                                   f"{depth}")
        ps = self.page_size
        self.allocator.retag(page, f"prefix:{key}")
        node = PrefixNode(key=key, namespace=self.namespace(tenant),
                          depth=depth, page=page,
                          tokens=np.asarray(
                              tokens[depth * ps:(depth + 1) * ps],
                              np.int32).copy(),
                          parent=parent.key if parent else None)
        self.nodes[key] = node
        return self._insert(node, parent)

    def graft(self, src: PrefixNode, page: int) -> PrefixNode | None:
        """Install a copy of a donor engine's full-block node (pre-warm).
        The caller owns ``page`` and has copied the donor page's KV into
        it; it is retagged to the cache as a refcount-0 node.  None --
        the caller keeps or frees its page -- when the block is already
        cached, is a partial tail, or its parent is not cached here
        (graft root first)."""
        if src.partial or src.key in self.nodes:
            return None
        parent = None
        if src.parent is not None:
            parent = self.nodes.get(src.parent)
            if parent is None:
                return None
        self.allocator.retag(page, f"prefix:{src.key}")
        node = PrefixNode(key=src.key, namespace=src.namespace,
                          depth=src.depth, page=page,
                          tokens=np.asarray(src.tokens, np.int32).copy(),
                          parent=parent.key if parent else None)
        self.nodes[src.key] = node
        return self._insert(node, parent)

    def adopt_tail(self, tenant: str, tokens, copy_page) -> PrefixNode | None:
        """Cache the partial tail block of ``tokens`` by copying: a fresh
        cache-owned page is allocated and ``copy_page(dst_page)`` fills
        it from the caller's private tail page.  Best effort: None when
        there is no tail, no page, or an equal tail is already cached."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        rem = len(tokens) % ps
        if rem == 0:
            return None
        keys = self.chain_keys(tenant, tokens)
        depth = len(tokens) // ps
        if depth > 0 and (not keys or keys[-1] not in self.nodes):
            return None              # the chain below the tail isn't cached
        parent_key = keys[-1] if depth > 0 \
            else _root_key(self.namespace(tenant))
        tail_tokens = tokens[depth * ps:]
        sibs = self.tails.setdefault(parent_key, [])
        for cand in sibs:
            if _common_prefix(cand.tokens, tail_tokens) == rem:
                return None          # already covered
        if len(sibs) >= _MAX_TAILS:
            victim = min((c for c in sibs if c.refs == 0),
                         key=lambda c: c.stamp, default=None)
            if victim is None:
                return None
            self._evict(victim)
        key = _child_key(parent_key, tail_tokens)
        pages = self.allocator.alloc(1, f"prefix:{key}")
        if pages is None:
            return None
        copy_page(pages[0])
        parent = self.nodes.get(parent_key)
        node = PrefixNode(key=key, namespace=self.namespace(tenant),
                          depth=depth, page=pages[0],
                          tokens=tail_tokens.copy(), parent=parent_key
                          if parent else None, partial=True)
        self.tails.setdefault(parent_key, []).append(node)
        return self._insert(node, parent)

    # -- eviction -----------------------------------------------------------
    def _every(self) -> list[PrefixNode]:
        return list(self.nodes.values()) \
            + [n for v in self.tails.values() for n in v]

    @property
    def pages_held(self) -> int:
        return len(self.nodes) + sum(len(v) for v in self.tails.values())

    def evictable_pages(self) -> int:
        """Refcount-0 pages: reclaimable on demand, so they count as free
        admission budget."""
        return sum(1 for n in self._every() if n.refs == 0)

    def _evict(self, node: PrefixNode):
        if node.refs != 0:
            raise RuntimeError(f"evicting referenced node {node.key} "
                               f"(refs {node.refs})")
        if node.partial:
            for pk, sibs in list(self.tails.items()):
                if node in sibs:
                    sibs.remove(node)
                    if not sibs:
                        del self.tails[pk]
                    break
        else:
            del self.nodes[node.key]
        if node.parent is not None and node.parent in self.nodes:
            parent = self.nodes[node.parent]
            if parent.refs <= 0:
                raise RuntimeError(f"parent {parent.key} of {node.key} "
                                   "holds no reference")
            parent.refs -= 1
        self.allocator.free([node.page])
        self.stats.evictions += 1

    def reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` refcount-0 pages, least recently used
        first (leaves before parents: a child holds a ref on its parent).
        Returns the number freed; referenced pages are never touched."""
        freed = 0
        while freed < n_pages:
            victims = [n for n in self._every() if n.refs == 0]
            if not victims:
                break
            self._evict(min(victims, key=lambda n: n.stamp))
            freed += 1
        return freed

    # -- invariants ---------------------------------------------------------
    def _children(self, every) -> dict[str, int]:
        children: dict[str, int] = {}
        for n in every:
            if n.parent is not None:
                children[n.parent] = children.get(n.parent, 0) + 1
        return children

    def _audit(self):
        """Allocator-attached auditor (runs inside ``allocator.check()``):
        every cached page is owned under its ``prefix:<key>`` tag, no page
        is cached twice, and refcounts are at least the child count."""
        every = self._every()
        children = self._children(every)
        for n in every:
            owner = self.allocator.owners.get(n.page)
            if owner != f"prefix:{n.key}":
                raise RuntimeError(f"cached page {n.page} of {n.key} is "
                                   f"owned by {owner!r}")
            if n.refs < children.get(n.key, 0):
                raise RuntimeError(f"node {n.key}: refs {n.refs} < "
                                   f"{children.get(n.key, 0)} children")
        pages = [n.page for n in every]
        if len(set(pages)) != len(pages):
            raise RuntimeError("cached page aliased")

    def check(self, row_refs=None):
        """Full refcount audit.  ``row_refs`` -- one node list per live
        engine row -- makes it exact: each node's refs must equal its row
        references plus its child count."""
        self._audit()
        if row_refs is None:
            return
        counts: dict[str, int] = {}
        for nodes in row_refs:
            for n in nodes:
                counts[n.key] = counts.get(n.key, 0) + 1
        every = self._every()
        children = self._children(every)
        for n in every:
            want = counts.get(n.key, 0) + children.get(n.key, 0)
            if n.refs != want:
                raise RuntimeError(f"node {n.key}: refs {n.refs} != {want} "
                                   "(row references + children)")


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n
