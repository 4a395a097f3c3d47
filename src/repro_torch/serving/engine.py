"""Serving engines (port of ``repro/serving/engine.py``): ``Request``, the
dense ``ServingEngine``, ``PagedServingEngine`` and the standalone INT8
KV helpers ``quantize_kv`` / ``dequantize_kv``.

``ServingEngine`` keeps one float KV cache per attention layer,
[max_batch, cache_len] (a ``local`` layer's a ring of ``min(window,
cache_len)`` slots), and serves every layer kind the port has: ``attn``,
``local`` (sliding window), ``rwkv``, ``rglru``, with any channel mix.
A prompt prefills token by token on a fresh batch-1 state through
``decode_step``, which then overwrites every leaf of the request's slot;
its last logits give the first output token (argmax, even when
sampling).  Each heartbeat runs up to ``decode_horizon`` steps of one
batched ``decode_step`` over all slots (``model.decode_horizon``),
draining [B, h] tokens once; an MoE layer routes each slot alone, as
the reference's per-slot ``vmap``.  It is the reference's path for
``local`` layers and softcaps, which the paged engine refuses.

``PagedServingEngine``'s host API and policy are the JAX engine's:

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

Both engines decode greedily by default; ``greedy=False`` samples at
``temperature`` from one ``torch.Generator`` per engine seeded by
``seed`` (``model.sample_tokens``: a step draws [B, V] whatever the slots
do, so a fused horizon samples what single steps would).

``jax.jit`` bodies become eager calls; every GEMM and attention read
goes through ``repro_torch.exec`` (``backend="auto"``: the CUDA kernels
for tensors on the card, the torch references on the CPU).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (batch_state_axes, decode_horizon,
                                      decode_horizon_paged, decode_step,
                                      forward_paged_chunk, init_decode_state,
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


class _Engine:
    """What both engines share: the params and the device they lie on
    (the engine runs there), the exec backend, the decode horizon and
    the sampler (one ``torch.Generator`` on the device, seeded by
    ``seed``).  An encoder-decoder is refused: its decoder needs the
    encoder's output, which no engine takes (the reference's engines
    accept one and decode without cross-attention); a vision stub's
    model serves its text, ``frontend_proj`` unused."""

    def __init__(self, params, cfg: ModelConfig, *, decode_horizon: int,
                 greedy: bool, temperature: float, seed: int, backend):
        from repro_torch.exec import get_backend
        cfg.check_ported()
        if cfg.encdec:
            raise NotImplementedError(
                f"{cfg.name}: the engines serve decoder-only models; an "
                "encoder-decoder decodes through models.decode_step("
                "enc_out=encode(...))")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
        self.decode_horizon = _check_horizon(decode_horizon)
        self.greedy = greedy
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.backend = get_backend(backend)

    @classmethod
    def from_exported(cls, params, cfg: ModelConfig, *, policy=None, **kw):
        """Export every quantized linear to INT8 codes + PO2 shift
        exponents, then serve them: INT8 weights through the APSQ GEMM
        kernels (and, on the paged engine, INT8 KV pages through the
        attention kernel)."""
        from repro_torch.quant.export import export_quantized
        deploy, _ = export_quantized(params, policy)
        return cls(deploy, cfg, **kw)

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)


# ---------------------------------------------------------------------------
# INT8 KV cache helpers (APSQ-style power-of-two scales)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """Per-(batch, head) power-of-two-scale INT8 codes of x [B, S, H, hd]:
    returns (codes int8, scale float32 [B, 1, H, 1])."""
    amax = x.float().abs().amax(dim=(1, 3), keepdim=True)
    scale = torch.exp2(torch.ceil(torch.log2(
        torch.clamp(amax, min=1e-8) / 127.0)))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# Dense engine
# ---------------------------------------------------------------------------

class ServingEngine(_Engine):
    """Continuous batching over dense float KV caches (module docstring).

    Knobs as the reference's: ``max_batch`` slots, ``cache_len``
    positions per slot (a slot is done at ``cache_len - 1``),
    ``decode_horizon`` (pow2 decode steps per heartbeat, default 1),
    ``greedy`` / ``temperature`` / ``seed``, ``backend``.  The
    reference's ``prefill_chunk`` (a padding bucket for its compiled
    prefill) has no counterpart: the port prefills a prompt's real
    tokens only, which gives the same state and logits."""

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 cache_len: int = 1024,
                 decode_horizon: int = 1, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0, backend="auto"):
        super().__init__(params, cfg, decode_horizon=decode_horizon,
                         greedy=greedy, temperature=temperature, seed=seed,
                         backend=backend)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.state = init_decode_state(cfg, max_batch, cache_len,
                                       device=self.device)
        self.pos = np.zeros(max_batch, np.int32)      # next position per slot
        self.slots: list = [None] * max_batch
        self.reset_counters()

    def reset_counters(self) -> None:
        self.prefill_tokens = 0        # prompt tokens prefilled
        self.prefill_seconds = 0.0     # wall time of those prefills
        self.decode_dispatches = 0     # decode macro-steps
        self.decode_device_steps = 0   # decode steps across them
        self.decode_seconds = 0.0      # wall time dispatch -> token drain
        self.horizon_hist: dict[int, int] = {}  # steps per macro-step

    # -- device bodies ------------------------------------------------------

    def _prefill(self, tokens, slot: int) -> torch.Tensor:
        """Prefill one prompt on a fresh batch-1 state, token by token,
        then overwrite every leaf of ``slot`` with it (K/V or ring,
        recurrent states), whatever the slot's last request left.
        Returns the last token's logits [1, V]."""
        cfg = self.cfg
        st = init_decode_state(cfg, 1, self.cache_len, device=self.device)
        toks = self._t(tokens).reshape(-1, 1)
        positions = torch.arange(len(tokens), dtype=torch.int32,
                                 device=self.device)
        lg = torch.zeros((1, 1, cfg.vocab), device=self.device)
        for t in range(len(tokens)):
            lg, st = decode_step(self.params, cfg, st, toks[t:t + 1],
                                 positions[t:t + 1], backend=self.backend)
        idx = torch.tensor([slot], device=self.device)
        self.state = tree_map(
            lambda _, full, s, ax: full.index_copy(ax, idx,
                                                   s.to(full.dtype)),
            self.state, st, batch_state_axes(self.state))
        return lg[:, -1]

    def _decode(self, h: int, tokens, pos, active, budget, remaining, eos):
        """``h`` batched decode steps over every slot
        (``model.decode_horizon``).  Every slot's state is written at
        every step, as in the reference: a slot masked mid-horizon is
        done by its end, and admission overwrites a slot whole."""
        def step(st, tok, ps, on):
            return decode_step(self.params, self.cfg, st, tok, ps,
                               backend=self.backend)
        return decode_horizon(
            step, self.state, tokens, pos, horizon=h, active=active,
            budget=budget, remaining=remaining, eos=eos, greedy=self.greedy,
            temperature=self.temperature, generator=self.generator)

    # -- host API -----------------------------------------------------------

    def add_request(self, req: Request) -> bool:
        """Prefill into a free slot; False if every slot is taken."""
        try:
            slot = self.slots.index(None)
        except ValueError:
            return False
        t0 = time.perf_counter()
        logits = self._prefill(np.asarray(req.tokens, np.int32), slot)
        req.out.append(int(torch.argmax(logits[0])))
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_tokens += len(req.tokens)
        self.slots[slot] = req
        self.pos[slot] = len(req.tokens)
        if len(req.out) >= req.max_new_tokens or req.hit_eos():
            req.done = True  # finished on the prefill token; step() sweeps
        return True

    def step(self) -> list:
        """One decode macro-step (up to ``decode_horizon`` tokens per
        slot) for every active slot; returns finished requests."""
        finished = []
        for i, r in enumerate(self.slots):  # finished at admission
            if r is not None and r.done:
                finished.append(r)
                self.slots[i] = None
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return finished
        B = self.max_batch
        tokens = np.zeros((B, 1), np.int32)
        mask = np.zeros(B, np.bool_)
        bud = np.zeros(B, np.int32)
        rem = np.zeros(B, np.int32)
        eos = np.full(B, -1, np.int32)
        for i in active:
            r = self.slots[i]
            tokens[i, 0] = r.out[-1]
            mask[i] = True
            rem[i] = r.max_new_tokens - len(r.out)
            # the last writable position is cache_len - 2
            bud[i] = min(self.decode_horizon,
                         self.cache_len - 1 - int(self.pos[i]))
            if r.eos_token is not None:
                eos[i] = r.eos_token
        h = max(1, max(int(min(bud[i], rem[i])) for i in active))
        h = 1 << (h - 1).bit_length()
        t0 = time.perf_counter()
        blk, em, self.state, _ = self._decode(
            h, self._t(tokens), self._t(self.pos),
            self._t(mask, torch.bool), self._t(bud), self._t(rem),
            self._t(eos))
        blk = blk.cpu().numpy()           # the macro-step's single host sync
        em = em.cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_dispatches += 1
        self.decode_device_steps += h
        self.horizon_hist[h] = self.horizon_hist.get(h, 0) + 1
        for i in active:
            r = self.slots[i]
            for t in range(h):
                if not em[i, t]:
                    break
                r.out.append(int(blk[i, t]))
                self.pos[i] += 1
            if (len(r.out) >= r.max_new_tokens
                    or self.pos[i] >= self.cache_len - 1 or r.hit_eos()):
                r.done = True
                finished.append(r)
                self.slots[i] = None
        return finished

    def run(self, requests: list) -> list:
        """Continuous batching until every request completes."""
        pending = list(requests)
        done: list = []
        while pending or any(s is not None for s in self.slots):
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            done.extend(self.step())
        return done


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------

class PagedServingEngine(_Engine):
    """Continuous-batching engine over the paged INT8 KV cache.

    Knobs: ``prefill_chunk`` (max tokens per prefill forward),
    ``prefill_token_budget`` (prompt tokens per ``step``; default one
    chunk per slot), ``decode_horizon`` (pow2 decode steps per
    heartbeat), ``max_pages_per_slot`` (bound it to the workload's
    footprint: every decode gathers that many pages per slot),
    ``greedy`` / ``temperature`` / ``seed``.  Full attention only: a
    ``local`` layer or a softcap is refused, as in the reference (serve
    those on ``ServingEngine``).

    ``mesh`` (``launch.mesh.make_smoke_mesh``) serves across the ranks
    of its ``model`` axis: the backend is wrapped in ``ShardedBackend``
    (``wire`` "int8" or "fp32"), the rank keeps its slices of the params
    (``dist.tp.shard_deployed``, from the whole export) and of the KV
    pools and exponents (``shard_paged_state``), and ``shard_plan``
    holds the ``{name: LayerPlan}`` report.  Every rank runs the same
    scheduler over the same requests and takes the same decisions: its
    tokens come from logits that the collectives make equal everywhere.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 page_size: int = 16, n_pages: int = 128,
                 max_pages_per_slot: int | None = None,
                 prefill_chunk: int = 16,
                 prefill_token_budget: int | None = None,
                 decode_horizon: int = 8, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0, backend="auto",
                 mesh=None, wire: str = "int8"):
        from .scheduler import Scheduler
        if "local" in cfg.block_pattern or cfg.softcap:
            raise NotImplementedError(
                "paged serving covers full-attention (+ recurrent) "
                "layers only — no sliding-window / softcap yet")
        self.mesh = mesh
        self.shard_plan = None
        if mesh is not None:
            from repro_torch.dist.tp import shard_deployed
            params, self.shard_plan = shard_deployed(params, mesh)
        super().__init__(params, cfg, decode_horizon=decode_horizon,
                         greedy=greedy, temperature=temperature, seed=seed,
                         backend=backend)
        if mesh is not None:
            from repro_torch.exec import ShardedBackend
            inner = (self.backend.inner
                     if isinstance(self.backend, ShardedBackend)
                     else self.backend)
            self.backend = ShardedBackend(mesh=mesh, inner=inner, wire=wire)
        self.max_batch = max_batch
        self.page_size = page_size
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.prefill_token_budget = max(
            int(prefill_token_budget) if prefill_token_budget
            else self.prefill_chunk * max_batch, 1)
        self.state = init_paged_decode_state(cfg, max_batch,
                                             page_size=page_size,
                                             n_pages=n_pages,
                                             device=self.device)
        fresh = init_paged_decode_state(cfg, 1, page_size=page_size,
                                        n_pages=1, device=self.device)
        if mesh is not None:
            from repro_torch.dist.tp import shard_paged_state
            self.state, attn_plans = shard_paged_state(self.state, cfg, mesh)
            fresh, _ = shard_paged_state(fresh, cfg, mesh)
            self.shard_plan.update(attn_plans)
        self._axes = paged_state_axes(self.state)
        # a newly admitted slot's per-slot leaves (running exponents at
        # EXP_FLOOR, recurrent states at zeros); None where shared
        self._fresh = tree_map(lambda _, fr, ax: None if ax == -1 else fr,
                               fresh, self._axes)
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
            remaining=self._t(rem), eos=self._t(eos), greedy=self.greedy,
            temperature=self.temperature, generator=self.generator,
            backend=self.backend)
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
