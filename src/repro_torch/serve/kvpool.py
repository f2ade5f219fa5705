"""Paged KV-cache pool: page-granular allocation over the DeviceRef plane
— the port of the JAX package's ``repro/serve/kvpool.py``.

The monolithic serve path (`ServeEngine` + ``init_fn``) holds each
request's decode state as one contiguous DeviceRef pytree sized for the
worst-case sequence. That wastes device memory on short sequences,
duplicates shared prompt prefixes per request, and — because ``init_fn``
runs inline in the decode loop — lets one long prefill stall every other
request's decode step.

This module is the paged alternative (the vLLM/PagedAttention discipline
mapped onto the actor data plane):

* :class:`PagePool` — a per-device allocator of fixed-size **pages**
  (``page_tokens`` token slots × the cache's per-token leaf shapes). Every
  page leaf is a :class:`~repro_torch.core.memref.DeviceRef`, so pages
  inherit the data plane's rights enforcement, byte accounting, leak
  checks and stream ordering. The pool registers itself with the
  process-wide :class:`~repro_torch.core.memref.RefRegistry`, which
  aggregates live/peak page counts, sharing, and fragmentation into
  ``memory_stats()``.
* :class:`PageTable` — one request's mapping from logical token positions
  to pages. ``prepare_append`` reserves the slot for the next token
  (allocating a fresh page at a page boundary, copy-on-write when the
  tail page is shared); ``commit_append`` installs the updated tail
  tensors only after the decode step *succeeded*, which is what keeps a
  replayed step (crashed worker) exactly-once.
* **Prefix reuse** — a completed prefill registers its pages in the
  pool's prefix cache under the prompt key. The pages are *sealed*
  (rights narrowed to ``"r"`` via ``DeviceRef.restrict``) and pinned;
  later requests with the same prompt map the very same pages with no
  new allocation and no prefill compute. A writer that reaches a shared
  page goes through copy-on-write (:meth:`PagePool.cow`); writing a
  sealed page directly raises
  :class:`~repro_torch.core.errors.AccessViolation`.
* :func:`make_prefill_worker` / :func:`make_paged_decode_worker` — the
  actor behaviors for **disaggregated serving**: a prefill worker pool
  consumes admitted prompts and writes their KV pages; the page table is
  handed to the decode engine as plain in-process refs (zero host
  transfers — no spill, no readback). Decode steps gather pages per
  batch slot on device, so the decode batch stays full while prefills
  run elsewhere.

Tensors are mutable where JAX arrays are not, so the rule that makes
copy-on-write and replay safe is explicit here: no page tensor is ever
written in place. A decode worker writes a request's new KV entry into a
*copy* of its tail page and the engine swaps that copy in on commit; a
COW clone may therefore share its source's tensors until that first
write. A page written on one thread's stream and gathered on another's
is ordered by its ``DeviceRef`` (``DeviceRef.array`` makes the reading
stream wait for the producing one).

Pages and tables are in-process handles (they wrap device-resident
refs); cross-node disaggregation is out of scope here.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..analysis.runtime import make_rlock
from ..core.errors import AccessViolation
from ..core.memref import (DeviceRef, as_device_array, default_device,
                           registry, to_numpy)
from ..core.signature import to_torch_dtype

__all__ = ["Page", "PagePool", "PageTable", "PoolExhausted",
           "make_prefill_worker", "make_paged_decode_worker"]


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — the request is shed, not the
    engine killed (size ``max_pages`` for max_batch × max sequence)."""


class Page:
    """One fixed-size block of KV storage: ``page_tokens`` token slots for
    every cache leaf, each leaf a :class:`DeviceRef`.

    ``refcount`` counts the holders (requests via their page tables, plus
    the prefix cache's pin). A page is **shared** when more than one
    holder exists or when it was sealed read-only for the prefix cache;
    shared pages must never be written — writers copy-on-write through
    :meth:`PagePool.cow` first.
    """

    __slots__ = ("pool", "refs", "refcount", "used", "sealed")

    def __init__(self, pool: "PagePool", refs: List[DeviceRef], used: int):
        self.pool = pool
        self.refs = refs                  # one DeviceRef per cache leaf
        self.refcount = 1
        self.used = used                  # valid token slots written
        self.sealed = False

    @property
    def page_tokens(self) -> int:
        return self.refs[0].shape[0]

    @property
    def shared(self) -> bool:
        return self.sealed or self.refcount > 1

    def arrays(self) -> List[torch.Tensor]:
        """The per-leaf device tensors (read access — works on sealed
        pages; the decode gather path uses this)."""
        return [r.array for r in self.refs]

    def writable_arrays(self) -> List[torch.Tensor]:
        """The per-leaf tensors *for writing* (into a copy, see the module
        docstring). Raises :class:`AccessViolation` on a sealed
        (read-restricted, shared) page — the engine must copy-on-write
        first. This is the safety boundary the prefix cache relies on: a
        buggy writer cannot corrupt a sibling request's prefix."""
        for r in self.refs:
            if not r.writable:
                raise AccessViolation(
                    "page is read-restricted (shared prefix); writing "
                    "requires a private copy — the engine must "
                    "copy-on-write (PagePool.cow) before appending")
        return [r.array for r in self.refs]

    def _seal(self) -> None:
        """Narrow every leaf to read-only (``restrict('r')``) — called
        when the page enters the prefix cache. Idempotent."""
        if self.sealed:
            return
        narrowed = [r.restrict("r") for r in self.refs]
        for r in self.refs:
            r.release()
        self.refs = narrowed
        self.sealed = True

    def _replace(self, new_arrays: Sequence[torch.Tensor]) -> None:
        """Swap in updated leaf tensors (a committed decode write). Only
        legal on a private page — the engine guarantees that via
        ``prepare_append``."""
        if self.sealed:
            raise AccessViolation(
                "cannot replace the contents of a sealed (shared) page")
        old = self.refs
        self.refs = [DeviceRef(a) for a in new_arrays]
        for r in old:
            r.release()

    def __repr__(self):
        return (f"Page(tokens={self.used}/{self.page_tokens}, "
                f"refcount={self.refcount}, "
                f"{'sealed' if self.sealed else 'rw'})")


class _PrefixEntry:
    __slots__ = ("pages", "length", "first_token")

    def __init__(self, pages, length, first_token):
        self.pages = pages
        self.length = length
        self.first_token = first_token


class PagePool:
    """Fixed-capacity allocator of KV pages on one device.

    ``leaf_specs`` describes the cache's per-token layout: one
    ``(shape, dtype)`` per leaf (a torch or numpy dtype), *excluding* the
    leading token axis — a page for leaf ``i`` is a tensor of shape
    ``(page_tokens, *shape_i)``. Use :meth:`for_entries` to derive the
    specs (and the pytree structure) from an example prefill result.
    ``device`` is where pages live: a ``torch.device``, a device string
    or the runtime's ``Device``; by default the current CUDA device
    (:class:`LookupError` without one).

    All mutation goes through the pool lock; the pool registers itself
    with the DeviceRef :class:`~repro_torch.core.memref.RefRegistry` so
    page pressure shows up in ``memory_stats()`` /
    ``DeviceManager.memory_stats()`` next to the byte watermarks.
    """

    def __init__(self, leaf_specs: Sequence[Tuple[tuple, Any]],
                 treedef=None, *, page_tokens: int = 16,
                 max_pages: int = 256, device=None, max_prefixes: int = 64):
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        if not leaf_specs:
            raise ValueError("need at least one cache leaf spec")
        self.leaf_specs = [(tuple(s), to_torch_dtype(d))
                           for s, d in leaf_specs]
        self.treedef = treedef
        self.page_tokens = int(page_tokens)
        self.max_pages = int(max_pages)
        self.max_prefixes = int(max_prefixes)
        device = getattr(device, "torch_device", device)
        device = default_device() if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # reentrant: eviction under allocation pressure releases pages
        # while the allocation already holds the lock
        self._lock = make_rlock("PagePool")
        self._pages: set = set()          # live Page objects (bookkeeping)
        self._live = 0
        self._peak = 0
        self._prefix: "OrderedDict[Any, _PrefixEntry]" = OrderedDict()
        self.counters = {"allocated": 0, "freed": 0, "cow": 0,
                         "prefix_hits": 0, "prefix_misses": 0,
                         "prefix_evicted": 0}
        registry.register_pool(self)

    @classmethod
    def for_entries(cls, example_entries, **kw) -> "PagePool":
        """Derive leaf specs from an example prefill result: a pytree
        whose leaves are ``[T, *per_token_shape]`` tensors or arrays."""
        leaves, treedef = pytree.tree_flatten(example_entries)
        if not leaves:
            raise ValueError("example entries pytree has no leaves")
        specs = [(tuple(l.shape[1:]), l.dtype if hasattr(l, "dtype")
                  else np.asarray(l).dtype) for l in leaves]
        if "device" not in kw and isinstance(leaves[0], torch.Tensor):
            kw["device"] = leaves[0].device
        return cls(specs, treedef, **kw)

    # -- allocation ------------------------------------------------------
    def _new_page(self, arrays: List[torch.Tensor], used: int) -> Page:
        with self._lock:
            if self._live >= self.max_pages:
                self._evict_for_space()
            if self._live >= self.max_pages:
                raise PoolExhausted(
                    f"page pool exhausted ({self.max_pages} pages of "
                    f"{self.page_tokens} tokens); nothing evictable")
            refs = []
            try:
                for a, (shape, dtype) in zip(arrays, self.leaf_specs):
                    arr = as_device_array(a, device=self.device)
                    if tuple(arr.shape) != (self.page_tokens,) + shape:
                        raise ValueError(
                            f"page leaf shape {tuple(arr.shape)} != "
                            f"{(self.page_tokens,) + shape}")
                    refs.append(DeviceRef(arr))
            except BaseException:
                for r in refs:
                    r.release()
                raise
            page = Page(self, refs, used)
            self._pages.add(page)
            self._live += 1
            self._peak = max(self._peak, self._live)
            self.counters["allocated"] += 1
            return page

    def alloc_page(self, used: int = 0) -> Page:
        """A fresh zero-filled private page (the decode tail allocation)."""
        arrays = [torch.zeros((self.page_tokens,) + shape, dtype=dtype,
                              device=self.device)
                  for shape, dtype in self.leaf_specs]
        return self._new_page(arrays, used)

    def write_pages(self, entries) -> Tuple[List[Page], int]:
        """Slice a prefill result (leaves ``[T, *per_token]``) into pages.

        Full pages are copied out of the entry tensors (no zero-init); a
        partial tail page is zero-padded to ``page_tokens``. On any
        failure the pages already carved are released — a crashed or
        replayed prefill never leaks."""
        leaves = pytree.tree_leaves(entries)
        if len(leaves) != len(self.leaf_specs):
            raise ValueError(
                f"prefill entries have {len(leaves)} leaves; pool expects "
                f"{len(self.leaf_specs)}")
        leaves = [as_device_array(l, device=self.device) for l in leaves]
        length = int(leaves[0].shape[0])
        for l in leaves:
            if int(l.shape[0]) != length:
                raise ValueError("prefill entry leaves disagree on length")
        pt = self.page_tokens
        n_pages = max(1, math.ceil(length / pt))
        pages: List[Page] = []
        try:
            for p in range(n_pages):
                lo, hi = p * pt, min((p + 1) * pt, length)
                arrays = []
                for leaf, (shape, dtype) in zip(leaves, self.leaf_specs):
                    chunk = torch.zeros((pt,) + shape, dtype=dtype,
                                        device=self.device)
                    chunk[:hi - lo] = leaf[lo:hi]
                    arrays.append(chunk)
                pages.append(self._new_page(arrays, used=hi - lo))
        except BaseException:
            self.release_pages(pages)
            raise
        return pages, length

    def cow(self, page: Page) -> Page:
        """Copy-on-write: a private clone of ``page`` for a diverging
        writer. The clone shares the source's tensors; the copy happens
        at the first write, which the decode worker makes into a new
        tensor (the "on write" in copy-on-write). Counts as a fresh page
        against the pool cap."""
        with self._lock:
            clone = self._new_page(page.arrays(), used=page.used)
            self.counters["cow"] += 1
            return clone

    # -- holder accounting ----------------------------------------------
    def retain(self, page: Page) -> Page:
        with self._lock:
            page.refcount += 1
            return page

    def release_page(self, page: Page) -> None:
        with self._lock:
            if page not in self._pages:
                return                    # already fully freed
            page.refcount -= 1
            if page.refcount <= 0:
                for r in page.refs:
                    r.release()
                page.refs = []
                self._pages.discard(page)
                self._live -= 1
                self.counters["freed"] += 1

    def release_pages(self, pages: Sequence[Page]) -> None:
        for p in pages:
            self.release_page(p)

    # -- prefix cache ----------------------------------------------------
    @staticmethod
    def prefix_key(prompt) -> Any:
        """A hashable key for a prompt (token tuple for array-likes)."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        try:
            arr = np.asarray(prompt)
        except Exception:
            return prompt
        if arr.dtype == object:
            return prompt
        if arr.ndim == 0:
            return (arr.item(),)
        return tuple(arr.ravel().tolist())

    def prefix_lookup(self, key) -> Optional[Tuple[List[Page], int, Any]]:
        """Map a cached prefix: returns ``(pages, length, first_token)``
        with every page retained for the caller, or None on miss. The
        pages come back sealed (read-only) — appending past them goes
        through copy-on-write."""
        with self._lock:
            entry = self._prefix.get(key)
            if entry is None:
                self.counters["prefix_misses"] += 1
                return None
            self._prefix.move_to_end(key)          # LRU touch
            for p in entry.pages:
                p.refcount += 1
            self.counters["prefix_hits"] += 1
            return list(entry.pages), entry.length, entry.first_token

    def prefix_insert(self, key, pages: List[Page], length: int,
                      first_token) -> Tuple[List[Page], int, Any]:
        """Publish a completed prefill's pages under ``key``: seals them
        read-only and pins them (one refcount held by the cache). If a
        concurrent prefill of the same prompt won the race, the caller's
        pages are released and the canonical entry returned instead —
        shared-prefix pages stay allocated exactly once."""
        with self._lock:
            entry = self._prefix.get(key)
            if entry is not None:
                self._prefix.move_to_end(key)
                for p in entry.pages:
                    p.refcount += 1
                self.release_pages(pages)          # loser's copy
                return list(entry.pages), entry.length, entry.first_token
            for p in pages:
                p._seal()
                p.refcount += 1                    # the cache's pin
            self._prefix[key] = _PrefixEntry(list(pages), length,
                                             first_token)
            while len(self._prefix) > self.max_prefixes:
                self._evict_one_locked()
            return list(pages), length, first_token

    def _evict_one_locked(self) -> bool:
        if not self._prefix:
            return False
        _, entry = self._prefix.popitem(last=False)   # LRU out
        self.release_pages(entry.pages)
        self.counters["prefix_evicted"] += 1
        return True

    def _evict_for_space(self) -> None:
        """Under allocation pressure, drop prefix entries whose pages are
        held *only* by the cache pin (their owning requests finished) —
        those free real pages; entries still mapped by live requests
        would not, so they are kept."""
        for key in list(self._prefix):
            if self._live < self.max_pages:
                return
            entry = self._prefix[key]
            if all(p.refcount == 1 for p in entry.pages):
                del self._prefix[key]
                self.release_pages(entry.pages)
                self.counters["prefix_evicted"] += 1

    def evict_prefixes(self) -> int:
        """Drop every prefix entry (tests / explicit teardown); pages
        still mapped by running requests survive until those release."""
        with self._lock:
            n = 0
            while self._evict_one_locked():
                n += 1
            return n

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            used = sum(p.used for p in self._pages)
            slots = self._live * self.page_tokens
            shared = sum(1 for p in self._pages if p.shared)
            return {
                "page_tokens": self.page_tokens,
                "pages_total": self.max_pages,
                "pages_live": self._live,
                "pages_free": self.max_pages - self._live,
                "pages_shared": shared,
                "peak_pages": self._peak,
                "used_slots": used,
                "page_slots": slots,
                "fragmentation": (1.0 - used / slots) if slots else 0.0,
                "prefix_entries": len(self._prefix),
                **self.counters,
            }


class PageTable:
    """One request's logical-token-position → page mapping.

    ``length`` is the number of valid tokens; position ``p`` lives in
    page ``p // page_tokens`` at offset ``p % page_tokens``. The decode
    engine drives the two-phase append: :meth:`prepare_append` *reserves*
    the slot (fresh page at a boundary, copy-on-write when the tail is
    shared) before dispatching the step, and :meth:`commit_append`
    installs the worker's updated tail tensors only after the step
    succeeded — a replayed step re-reads the unmodified pages.
    """

    __slots__ = ("pool", "pages", "length")

    def __init__(self, pool: PagePool, pages: Optional[List[Page]] = None,
                 length: int = 0):
        self.pool = pool
        self.pages = list(pages) if pages else []
        self.length = int(length)

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.pool.page_tokens

    def tail_offset(self) -> int:
        """Offset inside the tail page where the *next* token lands."""
        return self.length - (len(self.pages) - 1) * self.pool.page_tokens

    def prepare_append(self) -> Tuple[Page, int]:
        """Reserve the slot for token ``length``: allocate a page at a
        page boundary; copy-on-write when the tail page is shared (the
        divergence point of a shared prefix). Returns (tail, offset)."""
        pt = self.pool.page_tokens
        if self.length == self.capacity:
            self.pages.append(self.pool.alloc_page())
        else:
            tail = self.pages[-1]
            if tail.shared:
                clone = self.pool.cow(tail)
                self.pool.release_page(tail)
                self.pages[-1] = clone
        return self.pages[-1], self.length - (len(self.pages) - 1) * pt

    def commit_append(self, new_tail_arrays: Sequence[torch.Tensor]) -> None:
        """Install the decode step's updated tail-page tensors and advance
        ``length`` — called only after the step succeeded."""
        tail = self.pages[-1]
        tail._replace(list(new_tail_arrays))
        self.length += 1
        tail.used = max(tail.used, self.tail_offset())

    def gather(self):
        """The request's full cache as one pytree (leaves concatenated
        over its pages, ``[capacity, *per_token]``) — test/debug surface;
        the decode worker does the batched equivalent on device."""
        cols = [torch.cat([p.arrays()[i] for p in self.pages])
                for i in range(len(self.pool.leaf_specs))]
        if self.pool.treedef is None:
            return tuple(cols)
        return pytree.tree_unflatten(cols, self.pool.treedef)

    def release_pages(self) -> int:
        """Return every page to the pool (idempotent). Recognized by
        :func:`repro_torch.core.memref.tree_release`, so a
        speculative-race loser's page table handed back through the
        ChunkScheduler is reclaimed like any DeviceRef payload."""
        pages, self.pages = self.pages, []
        self.pool.release_pages(pages)
        return len(pages)

    def __repr__(self):
        return (f"PageTable({self.length} tokens over {len(self.pages)} "
                f"pages of {self.pool.page_tokens})")


# ----------------------------------------------------------------------------
# actor behaviors: the disaggregated prefill / decode split
# ----------------------------------------------------------------------------
def make_prefill_worker(prefill_fn: Callable, pool: PagePool, *,
                        share_prefixes: bool = True) -> Callable:
    """The prefill-phase actor behavior.

    ``prefill_fn(prompt) → (entries, first_token)`` where ``entries`` is
    the prompt's KV pytree with leaves ``[T, *per_token]``. The worker
    writes the entries into pool pages and returns ``(PageTable,
    first_token, prefix_hit)`` — a pure ref handoff, no host transfer.

    With ``share_prefixes`` (default) the prompt key is checked against
    the pool's prefix cache first: a hit maps the cached (sealed) pages
    with **zero** new allocation and zero prefill compute; a miss
    publishes the freshly written pages for the next request. Page
    allocation is all-or-nothing, so a worker that crashes mid-prefill
    (and is replayed exactly-once by the ChunkScheduler) leaks nothing.
    """

    def prefill(tag: str, prompt):
        if tag != "prefill":
            raise ValueError(f"prefill worker got unknown message {tag!r}")
        key = pool.prefix_key(prompt) if share_prefixes else None
        if key is not None:
            hit = pool.prefix_lookup(key)
            if hit is not None:
                pages, length, first = hit
                return PageTable(pool, pages=pages, length=length), first, True
        entries, first = prefill_fn(prompt)
        pages, length = pool.write_pages(entries)
        if key is not None:
            pages, length, first = pool.prefix_insert(key, pages, length,
                                                      first)
        return PageTable(pool, pages=pages, length=length), first, False

    return prefill


def make_paged_decode_worker(step_fn: Callable, pool: PagePool) -> Callable:
    """The decode-phase actor behavior over paged caches.

    ``step_fn(kv, lengths[B], tokens[B]) → (next_tokens[B], entries)``
    where ``kv`` is the cache pytree with leaves ``[B, T, *per_token]``
    (``T`` = the batch's max page capacity; positions ≥ ``lengths[b]``
    are padding) and ``entries`` has leaves ``[B, *per_token]`` — the new
    token's KV entry, which the worker writes into each request's tail
    page at its reserved offset. ``lengths`` and ``tokens`` are int32
    tensors on the pool's device.

    Per step the worker *gathers* each request's pages into the batched
    ``kv`` on device (no host traffic), runs the step eagerly, and
    returns the updated tail tensors (new tensors: it never writes the
    pages, so a crashed step replays verbatim on another replica). The
    token read-back is the step's one host synchronisation. Writing the
    tail goes through :meth:`Page.writable_arrays`: if the engine ever
    handed over a still-shared tail, the step fails with
    ``AccessViolation`` instead of corrupting a sibling request's prefix.
    """
    pt = pool.page_tokens
    nleaves = len(pool.leaf_specs)
    device = pool.device

    def decode(tag: str, tokens: tuple, rows: tuple):
        if tag != "pstep":
            raise ValueError(f"decode worker got unknown message {tag!r}")
        max_pages = max(len(pages) for pages, _ in rows)
        cols = []
        for i in range(nleaves):
            shape, dtype = pool.leaf_specs[i]
            pad = None
            per_req = []
            for pages, _length in rows:
                arrs = [p.arrays()[i] for p in pages]
                if len(pages) < max_pages:
                    if pad is None:
                        pad = torch.zeros((pt,) + shape, dtype=dtype,
                                          device=device)
                    arrs.extend([pad] * (max_pages - len(pages)))
                per_req.append(torch.cat(arrs) if len(arrs) > 1
                               else arrs[0])
            cols.append(torch.stack(per_req))
        kv = (tuple(cols) if pool.treedef is None
              else pytree.tree_unflatten(cols, pool.treedef))
        lengths = torch.tensor([length for _, length in rows],
                               dtype=torch.int32, device=device)
        # claim the tail writes up front: a shared tail fails loudly here
        # (AccessViolation), before any compute is spent
        tails = [pages[-1].writable_arrays() for pages, _ in rows]
        with torch.no_grad():
            new_tokens, entries = step_fn(
                kv, lengths, torch.tensor(tokens, dtype=torch.int32,
                                          device=device))
        entry_leaves = pytree.tree_leaves(entries)
        if len(entry_leaves) != nleaves:
            raise ValueError(
                f"paged step returned {len(entry_leaves)} entry leaves; "
                f"the pool's cache has {nleaves}")
        out = []
        for b, (pages, length) in enumerate(rows):
            off = length - (len(pages) - 1) * pt
            row = []
            for i in range(nleaves):
                tail = tails[b][i].clone()
                tail[off] = entry_leaves[i][b]
                row.append(tail)
            out.append(tuple(row))
        return to_numpy(new_tokens), tuple(out)

    return decode
