"""Continuous-batching serving over the paged INT8 KV cache (port of
``PagedServingEngine`` and ``Request`` in ``repro/serving/engine.py``).

The host API and policy are the JAX engine's:

  * admission books a slot once its FIRST prefill chunk's pages fit;
  * prompts prefill in power-of-two chunks of up to ``prefill_chunk``
    tokens under a per-step ``prefill_token_budget``, oldest slot first;
    a chunk whose pages cannot grow pauses at the chunk boundary unless
    a later-admitted slot can be evicted;
  * decode runs up to ``decode_horizon`` steps per heartbeat
    (``decode_horizon_paged``), with each slot's pages reserved over the
    horizon by ``_ensure_capacity`` (the first page may preempt the
    latest-admitted request; the rest only shrinks the slot's budget);
  * preempted requests requeue at the front and re-prefill prompt +
    output on re-admission, bit-identical to the uninterrupted decode;
  * requests stop on ``max_new_tokens``, page budget, or ``eos_token``.

``jax.jit`` bodies become eager calls; every GEMM and attention read
goes through ``repro_torch.exec`` (``backend="auto"``: the CUDA kernels
for tensors on the card, the torch references on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_horizon_paged,
                                      forward_paged_chunk,
                                      init_paged_decode_state,
                                      paged_state_axes, tree_map)
from .paged_cache import NULL_PAGE, page_span


def _check_horizon(h) -> int:
    h = int(h)
    if h < 1 or (h & (h - 1)):
        raise ValueError(f"decode_horizon must be a power of two >= 1, "
                         f"got {h}")
    return h


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray            # prompt
    max_new_tokens: int = 32
    eos_token: int | None = None  # stop when this token is generated
    out: list = dataclasses.field(default_factory=list)
    done: bool = False

    def hit_eos(self) -> bool:
        return (self.eos_token is not None and len(self.out) > 0
                and self.out[-1] == self.eos_token)


def _params_device(params) -> torch.device:
    return params["embed"]["table"].device


class PagedServingEngine:
    """Continuous-batching engine over the paged INT8 KV cache.

    Knobs: ``prefill_chunk`` (max tokens per prefill forward),
    ``prefill_token_budget`` (prompt tokens per ``step``; default one
    chunk per slot), ``decode_horizon`` (pow2 decode steps per
    heartbeat), ``max_pages_per_slot`` (bound it to the workload's
    footprint: every decode gathers that many pages per slot).  Decoding
    is greedy.  The engine runs on the device of ``params``.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 page_size: int = 16, n_pages: int = 128,
                 max_pages_per_slot: int | None = None,
                 prefill_chunk: int = 16,
                 prefill_token_budget: int | None = None,
                 decode_horizon: int = 8, backend="auto"):
        from repro_torch.exec import get_backend
        from .scheduler import Scheduler
        cfg.check_ported()
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self.max_batch = max_batch
        self.page_size = page_size
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.prefill_token_budget = max(
            int(prefill_token_budget) if prefill_token_budget
            else self.prefill_chunk * max_batch, 1)
        self.decode_horizon = _check_horizon(decode_horizon)
        self.backend = get_backend(backend)
        self.state = init_paged_decode_state(cfg, max_batch,
                                             page_size=page_size,
                                             n_pages=n_pages,
                                             device=self.device)
        self._axes = paged_state_axes(self.state)
        # a newly admitted slot's per-slot leaves (running exponents at
        # EXP_FLOOR, recurrent states at zeros); None where shared
        self._fresh = tree_map(
            lambda _, fr, ax: None if ax == -1 else fr,
            init_paged_decode_state(cfg, 1, page_size=page_size, n_pages=1,
                                    device=self.device), self._axes)
        self.sched = Scheduler(max_slots=max_batch, n_pages=n_pages,
                               page_size=page_size,
                               max_pages_per_slot=max_pages_per_slot,
                               admit_chunk=self.prefill_chunk)
        self.pos = np.zeros(max_batch, np.int32)      # next position per slot
        # slot -> full resume stream while mid-prefill (pos = prefilled len)
        self._mid_prefill: dict[int, np.ndarray] = {}
        self.reset_counters()

    def reset_counters(self) -> None:
        self.prefill_dispatches = 0  # prefill chunk forwards
        self.decode_dispatches = 0   # decode macro-steps
        self.horizon_hist: dict[int, int] = {}  # steps per macro-step

    @classmethod
    def from_exported(cls, params, cfg: ModelConfig, *, policy=None, **kw):
        """Export every quantized linear to INT8 codes + PO2 shift
        exponents, then serve them: INT8 weights through the APSQ GEMM
        kernels and INT8 KV pages through the attention kernel."""
        from repro_torch.quant.export import export_quantized
        deploy, _ = export_quantized(params, policy)
        return cls(deploy, cfg, **kw)

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    # -- device bodies ------------------------------------------------------

    def _run_prefill_chunk(self, tokens, slot: int, start: int, table_row):
        """Prefill one chunk of one slot against the shared pools; the
        first chunk (start 0) resets the slot's per-slot leaves to a fresh
        state's (running exponents to ``EXP_FLOOR``, recurrent states to
        zeros), whatever a prior occupant left there."""
        axes = self._axes
        if start == 0:
            sub = tree_map(lambda _, full, fr, ax: full if ax == -1 else fr,
                           self.state, self._fresh, axes)
        else:
            sub = tree_map(lambda _, full, ax: full if ax == -1
                           else full[slot:slot + 1], self.state, axes)
        lg, st = forward_paged_chunk(
            self.params, self.cfg, sub, tokens, self._t([start]), table_row,
            backend=self.backend)

        def put(path, full, s, ax):
            if ax == -1:
                return s
            out = full.clone()
            out[slot:slot + 1] = s.to(full.dtype)
            return out

        self.state = tree_map(put, self.state, st, axes)
        return lg[:, -1]

    # -- host API -----------------------------------------------------------

    def add_request(self, req: Request) -> bool:
        self.sched.submit(req)
        return True

    def _admit(self) -> None:
        while True:
            got = self.sched.admit_next()
            if got is None:
                return
            slot, req, resume = got
            self._mid_prefill[slot] = np.asarray(resume, np.int32)
            self.pos[slot] = 0

    def _preempt(self, slot: int) -> None:
        self._mid_prefill.pop(slot, None)
        self.sched.preempt(slot)

    def _grow_range(self, slot: int, start: int, end: int) -> bool:
        """Pages for [start, end); a dry pool evicts only slots admitted
        later than ``slot``.  False: pause at this chunk boundary."""
        for p in page_span(start, end, self.page_size):
            while not self.sched.grow(slot, p):
                victim = self.sched.evict_candidate(exclude=slot)
                if victim is None or (self.sched._admitted_at[victim]
                                      <= self.sched._admitted_at[slot]):
                    return False
                self._preempt(victim)
        return True

    def _prefill_step(self) -> None:
        """Advance mid-prefill slots oldest first within the token budget,
        in power-of-two chunks; the last chunk's logits give the first
        output token."""
        budget = self.prefill_token_budget
        order = sorted(self._mid_prefill,
                       key=lambda s: self.sched._admitted_at[s])
        for s in order:
            if s not in self._mid_prefill:            # evicted by a grow
                continue
            resume = self._mid_prefill[s]
            while budget > 0 and int(self.pos[s]) < len(resume):
                done = int(self.pos[s])
                c = min(self.prefill_chunk, len(resume) - done, budget)
                c = 1 << (c.bit_length() - 1)         # pow2 chunk sizes
                if not self._grow_range(s, done, done + c):
                    return                            # pool dry: pause
                logits = self._run_prefill_chunk(
                    self._t(resume[done:done + c][None]), s, done,
                    self._t(self.sched.table[s:s + 1]))
                self.prefill_dispatches += 1
                self.pos[s] = done + c
                budget -= c
                if done + c == len(resume):           # prompt fully cached
                    req = self.sched.slots[s]
                    req.out.append(int(torch.argmax(logits[0])))
                    del self._mid_prefill[s]
                    if len(req.out) >= req.max_new_tokens or req.hit_eos():
                        req.done = True
            if budget <= 0:
                return

    def _ensure_capacity(self, horizon: int = 1):
        """Grow each decoding slot's pages for its next write (preempting
        the latest-admitted if dry) plus, opportunistically, the rest of
        its horizon.  Returns (finished, per-slot step budgets)."""
        finished = []
        budgets = np.zeros(self.max_batch, np.int32)
        order = sorted(
            (s for s, r in enumerate(self.sched.slots)
             if r is not None and s not in self._mid_prefill),
            key=lambda s: self.sched._admitted_at[s])
        for s in order:
            if self.sched.slots[s] is None:           # evicted below
                continue
            pos = int(self.pos[s])
            if pos >= self.sched.capacity_tokens:
                r = self.sched.finish(s)              # page budget exhausted
                r.done = True
                finished.append(r)
                continue
            guaranteed = True
            while not self.sched.grow(s, pos):
                victim = self.sched.evict_candidate()
                if victim is None or victim == s:
                    if victim == s:
                        self._preempt(s)
                        guaranteed = False
                        break
                    raise RuntimeError("page pool dry with no evictable slot")
                self._preempt(victim)
            if not guaranteed:
                continue
            r = self.sched.slots[s]
            want = max(1, min(horizon, self.sched.capacity_tokens - pos,
                              r.max_new_tokens - len(r.out)))
            covered = min(pos + want,
                          (pos // self.page_size + 1) * self.page_size)
            if pos + want > covered:
                covered = min(pos + want, covered + self.sched.grow_span(
                    s, covered, pos + want))
            budgets[s] = covered - pos
        return finished, budgets

    def _admit_and_prefill(self) -> list:
        self._admit()
        self._prefill_step()
        finished = []
        for s, r in enumerate(self.sched.slots):
            if r is not None and r.done:              # done on prefill token
                finished.append(self.sched.finish(s))
        return finished

    def step(self) -> list:
        """One heartbeat: admit, prefill within the budget, reserve decode
        pages, one decode macro-step of up to ``decode_horizon`` tokens per
        decoding slot, then refill freed slots."""
        finished = self._admit_and_prefill()
        fin_cap, budgets = self._ensure_capacity(self.decode_horizon)
        finished.extend(fin_cap)
        active = [s for s, r in enumerate(self.sched.slots)
                  if r is not None and s not in self._mid_prefill]
        if not active:
            return finished
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        mask = np.zeros(B, np.bool_)
        rem = np.zeros(B, np.int32)
        eos = np.full(B, -1, np.int32)
        for s in active:
            r = self.sched.slots[s]
            tokens[s, 0] = r.out[-1]
            mask[s] = True
            rem[s] = r.max_new_tokens - len(r.out)
            if r.eos_token is not None:
                eos[s] = r.eos_token
        table = np.where(mask[:, None], self.sched.table, NULL_PAGE)
        h = max(1, max(int(budgets[s]) for s in active))
        h = 1 << (h - 1).bit_length()
        blk, em, self.state, _ = decode_horizon_paged(
            self.params, self.cfg, self.state, self._t(tokens),
            self._t(self.pos), self._t(table), horizon=h,
            active=self._t(mask, torch.bool), budget=self._t(budgets),
            remaining=self._t(rem), eos=self._t(eos), backend=self.backend)
        blk = blk.cpu().numpy()           # the macro-step's single host sync
        em = em.cpu().numpy()
        self.decode_dispatches += 1
        self.horizon_hist[h] = self.horizon_hist.get(h, 0) + 1
        for s in active:
            r = self.sched.slots[s]
            for t in range(h):
                if not em[s, t]:
                    break
                r.out.append(int(blk[s, t]))
                self.pos[s] += 1
            if len(r.out) >= r.max_new_tokens or r.hit_eos():
                r.done = True
                finished.append(self.sched.finish(s))
        if self.sched.waiting:                        # refill freed slots now
            finished.extend(self._admit_and_prefill())
        return finished

    def run(self, requests: list) -> list:
        """Continuous batching until every request completes."""
        for r in requests:
            self.sched.submit(r)
        done: list = []
        while self.sched.waiting or any(
                s is not None for s in self.sched.slots):
            done.extend(self.step())
            self.sched.assert_invariants()
        return done
