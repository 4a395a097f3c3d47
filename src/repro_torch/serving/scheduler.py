"""Request scheduler for continuous batching over the paged KV cache
(a copy of ``repro/serving/scheduler.py``, which the port does not import).

Host-side (pure python/numpy) policy layer under ``PagedServingEngine``:

  * ``PageAllocator`` — free-list over the physical page pool.  Page 0 is
    the reserved null page (``repro_torch.serving.paged_cache.NULL_PAGE``) and
    is never handed out; every other page is either on the free list or
    owned by exactly one slot — ``assert_conserved`` checks that
    invariant and the scheduler tests pin it across admit/grow/evict
    churn.
  * ``Scheduler`` — FIFO admission queue plus slot/page bookkeeping:
    - ``submit`` validates a request can ever fit (progress guarantee:
      its full footprint must fit the pool even when running alone);
    - ``admit_next`` pops the queue head when a slot AND the pages for
      the start of its prompt are available (admission never evicts — it
      just waits).  With ``admit_chunk`` set (the engine passes its
      ``prefill_chunk``), only the FIRST chunk's pages gate admission;
      the rest ``grow`` on demand as prefill chunks land, so a long
      prompt no longer has to reserve its whole footprint up front;
    - ``grow`` allocates the next page of a mid-decode slot, up to
      ``max_pages_per_slot``;
    - ``preempt`` releases a slot mid-decode and requeues its request at
      the *front* (preempt-latest / resume-first policy).  Resume is a
      re-prefill over prompt + generated tokens, which is bit-identical
      to the uninterrupted decode because the paged prefill body is the
      decode body.

The scheduler never touches device state; the engine translates its
page-table rows (``table`` [max_slots, max_pages_per_slot] int32, unused
entries = NULL_PAGE) into the decode's gather indices.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from .paged_cache import NULL_PAGE, page_span


class PageAllocator:
    """LIFO free-list of physical pages; page 0 reserved as the null page."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, []))

    def alloc(self, slot: int, n: int = 1) -> list[int] | None:
        """Hand ``n`` pages to ``slot``; None (no change) if pool is dry."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(got)
        return got

    def release(self, slot: int) -> int:
        """Return every page owned by ``slot`` to the free list."""
        pages = self._owned.pop(slot, [])
        self._free.extend(reversed(pages))
        return len(pages)

    def assert_conserved(self) -> None:
        """Free + owned partition pages 1..n-1 exactly (no leak, no dup)."""
        seen = list(self._free)
        for pages in self._owned.values():
            seen.extend(pages)
        if sorted(seen) != list(range(1, self.n_pages)):
            raise AssertionError(
                f"page accounting broken: free={sorted(self._free)} "
                f"owned={ {s: p for s, p in self._owned.items()} }")


@dataclasses.dataclass
class SchedulerStats:
    admitted: int = 0
    preempted: int = 0
    finished: int = 0


class Scheduler:
    """Admission queue + slot/page bookkeeping for continuous batching."""

    def __init__(self, *, max_slots: int, n_pages: int, page_size: int,
                 max_pages_per_slot: int | None = None,
                 admit_chunk: int | None = None):
        self.max_slots = max_slots
        self.page_size = page_size
        self.admit_chunk = admit_chunk
        self.max_pages_per_slot = min(
            n_pages - 1,
            max_pages_per_slot if max_pages_per_slot else n_pages - 1)
        self.alloc = PageAllocator(n_pages)
        self.waiting: deque = deque()
        self.slots: list = [None] * max_slots          # slot -> Request
        self._admit_seq = 0
        self._admitted_at = [0] * max_slots            # eviction ordering
        self.table = np.full((max_slots, self.max_pages_per_slot),
                             NULL_PAGE, np.int32)
        self.stats = SchedulerStats()

    # -- capacity ----------------------------------------------------------

    @property
    def capacity_tokens(self) -> int:
        """Max positions one slot can ever hold (its page budget)."""
        return self.max_pages_per_slot * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- queue -------------------------------------------------------------

    def submit(self, req) -> None:
        """Queue a request; rejects ones that could never run to completion."""
        need = self.pages_for(len(req.tokens) + req.max_new_tokens)
        if need > self.max_pages_per_slot:
            raise ValueError(
                f"request {req.uid}: needs {need} pages "
                f"(prompt {len(req.tokens)} + max_new {req.max_new_tokens} "
                f"tokens) > per-slot budget {self.max_pages_per_slot}")
        self.waiting.append(req)

    def admit_next(self):
        """Admit the queue head if a slot and its starting pages are free.

        Returns (slot, request, resume_tokens) or None.  ``resume_tokens``
        is the full prefill stream — prompt plus any tokens generated
        before a preemption — so resumed requests recompute their cache
        exactly.  Without ``admit_chunk`` the whole prompt's pages gate
        admission; with it only the first prefill chunk's do (later pages
        ``grow`` chunk by chunk).  Admission never evicts: if the pool
        cannot host the start of the prompt right now, the head waits for
        running requests to drain.
        """
        if not self.waiting:
            return None
        try:
            slot = self.slots.index(None)
        except ValueError:
            return None
        req = self.waiting[0]
        resume = np.concatenate(
            [np.asarray(req.tokens, np.int32),
             np.asarray(req.out, np.int32)]) if req.out else np.asarray(
                 req.tokens, np.int32)
        # +1: room for the token the prefill's final logits produce.
        first = len(resume) + 1
        if self.admit_chunk is not None:
            first = min(first, max(self.admit_chunk, 1))
        need = self.pages_for(first)
        pages = self.alloc.alloc(slot, need)
        if pages is None:
            return None
        self.waiting.popleft()
        self.slots[slot] = req
        self._admit_seq += 1
        self._admitted_at[slot] = self._admit_seq
        self.table[slot, :need] = pages
        self.stats.admitted += 1
        return slot, req, resume

    # -- mid-decode --------------------------------------------------------

    def grow_span(self, slot: int, start: int, end: int) -> int:
        """Opportunistically grow pages covering positions [start, end).

        Never evicts: allocation stops at the first page the pool cannot
        supply (pages already granted are kept — they cover the slot's
        next writes anyway).  Returns the number of positions covered
        from ``start``; the engine turns it into the slot's fused-decode
        step budget.  ``start`` must be page-aligned relative to the
        slot's already-guaranteed pages (the engine passes the end of the
        page holding ``pos``)."""
        covered = 0
        for pstart in page_span(start, end, self.page_size):
            if not self.grow(slot, pstart):
                break
            covered = pstart + self.page_size - start
        return max(covered, 0)

    def grow(self, slot: int, pos: int) -> bool:
        """Ensure the page holding position ``pos`` exists for ``slot``.

        True if the slot can write ``pos`` now; False if the pool is dry
        (caller evicts someone and retries).  Raises if ``pos`` is beyond
        the slot's page budget — the engine finishes such requests first.
        """
        idx = pos // self.page_size
        if idx >= self.max_pages_per_slot:
            raise ValueError(f"slot {slot}: pos {pos} beyond page budget")
        if self.table[slot, idx] != NULL_PAGE:
            return True
        got = self.alloc.alloc(slot, 1)
        if got is None:
            return False
        self.table[slot, idx] = got[0]
        return True

    def evict_candidate(self, exclude: int | None = None) -> int | None:
        """Latest-admitted active slot (preempt-latest loses least work)."""
        live = [s for s, r in enumerate(self.slots)
                if r is not None and s != exclude]
        if not live:
            return None
        return max(live, key=lambda s: self._admitted_at[s])

    def preempt(self, slot: int):
        """Release a slot mid-decode; its request requeues at the front."""
        req = self.slots[slot]
        self._clear(slot)
        self.waiting.appendleft(req)
        self.stats.preempted += 1
        return req

    def finish(self, slot: int):
        """Release a completed slot."""
        req = self.slots[slot]
        self._clear(slot)
        self.stats.finished += 1
        return req

    def _clear(self, slot: int) -> None:
        self.alloc.release(slot)
        self.table[slot] = NULL_PAGE
        self.slots[slot] = None

    # -- invariants --------------------------------------------------------

    def assert_invariants(self) -> None:
        """Free-list conservation + slot/table/ownership consistency."""
        self.alloc.assert_conserved()
        for s in range(self.max_slots):
            owned = set(self.alloc.pages_of(s))
            mapped = set(int(p) for p in self.table[s]) - {NULL_PAGE}
            if self.slots[s] is None:
                assert not owned and not mapped, f"slot {s} leaked pages"
            else:
                assert mapped == owned, (
                    f"slot {s}: table {sorted(mapped)} != "
                    f"owned {sorted(owned)}")
