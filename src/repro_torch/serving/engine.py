"""Serve engines: one-call prefill + slot-based continuous batching, from
``repro/serving/engine.py``.

``resolve_serve_engine(model_cfg, ServeConfig) -> ServePlan`` is the one
place that reads the ``batching`` / ``timing`` dispatch fields; engines
receive the resolved plan.  ``run(requests)`` yields one ``ServeEvent``
per lifecycle step on a virtual clock advanced by measured call durations
(``MeasuredTimer``, which synchronises the card) or a deterministic cost
model (``ModelTimer``).

Engines run on an explicit ``device`` (default ``"cuda"``; with no card
that raises unless ``device="cpu"`` is passed) and under
``torch.inference_mode()``.  At construction they hold a copy of the
params with every >= 2-D weight cast once to the activation dtype
(``lm.compute_params``): the same rounding the reference applies at every
call, so the results are identical.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.sanitize import sanctioned_scope

from .scheduler import Request, SlotAllocator

__all__ = [
    "ServeConfig", "ServePlan", "ServeEvent", "MeasuredTimer", "ModelTimer",
    "ServeEngine", "ContinuousServeEngine", "StaticServeEngine",
    "resolve_serve_engine", "make_serve_engine",
]


# ----------------------------------------------------------------------
# config & streaming surface
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs.  ``batching`` and ``timing`` are dispatch fields:
    only ``resolve_serve_engine`` inspects them."""
    slots: int = 8                 # fixed decode-batch capacity
    max_seq: int = 128             # per-slot cache length (prompt + gen)
    max_new_tokens: int = 16       # default generation budget per request
    batching: str = "continuous"   # continuous | static
    timing: str = "measured"       # measured | model (virtual cost clock)
    cache_dtype: str = "bfloat16"  # bfloat16 | float32 kv payload
    prefill_cost_ms: float = 0.05  # model timing: ms per prompt token
    decode_cost_ms: float = 1.0    # model timing: ms per decode step
    slot_cost_ms: float = 0.0      # model timing: ms per insert/evict

    def __post_init__(self):
        if self.batching not in ("continuous", "static"):
            raise ValueError(f"batching={self.batching!r}: "
                             "'continuous' or 'static'")
        if self.timing not in ("measured", "model"):
            raise ValueError(f"timing={self.timing!r}: 'measured' or 'model'")
        if self.cache_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"cache_dtype={self.cache_dtype!r}: "
                             "'bfloat16' or 'float32'")
        if self.slots < 1:
            raise ValueError("slots must be >= 1")


@dataclasses.dataclass
class ServeEvent:
    """One serving lifecycle step: ``arrival``, ``prefill`` (``token`` is
    the first generated id, ``ttft_ms`` the time to first token), ``token``
    (one decode step of ``decode_ms``), ``complete`` (``tokens`` is the
    whole generated sequence, ``latency_ms`` arrival to completion).
    ``t_ms`` is the virtual clock at emission."""
    kind: str
    request: int
    t_ms: float
    slot: int = -1
    token: int = -1
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    ttft_ms: float = 0.0
    latency_ms: float = 0.0
    tokens: Optional[List[int]] = None


# ----------------------------------------------------------------------
# timers: the virtual clock's duration source
# ----------------------------------------------------------------------
def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, lm.DecodeCache):
        return out.lengths
    if isinstance(out, (tuple, list)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


class MeasuredTimer:
    """Advance the clock by measured wall time; the card is synchronised
    before the clock is read, so the time covers the device work.  The
    sync is the measurement, so it is a sanctioned scope of the
    sanitizer (label ``measured-timer.<kind>``)."""
    source = "measured"

    def call(self, kind: str, units: float, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        with sanctioned_scope(f"measured-timer.{kind}"):
            t = _first_tensor(out)
            if t is not None and t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
        return out, (time.perf_counter() - t0) * 1e3


class ModelTimer:
    """Advance the clock by a deterministic cost model, so schedules
    replay the same whatever the host's speed."""
    source = "model"

    def __init__(self, prefill_cost_ms: float, decode_cost_ms: float,
                 slot_cost_ms: float = 0.0):
        self.prefill_cost_ms = prefill_cost_ms
        self.decode_cost_ms = decode_cost_ms
        self.slot_cost_ms = slot_cost_ms

    def call(self, kind: str, units: float, fn, *args):
        out = fn(*args)
        ms = {"prefill": units * self.prefill_cost_ms,
              "decode": self.decode_cost_ms,
              "slot": self.slot_cost_ms}[kind]
        return out, ms


# ----------------------------------------------------------------------
# the single config-resolution point
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ServePlan:
    """Resolved serving plan; engines read only this."""
    engine_cls: type
    batching: str              # substrate that will execute
    requested: str             # what the config asked for
    timer: Any                 # MeasuredTimer | ModelTimer
    slots: int
    max_seq: int
    max_new_tokens: int
    cache_dtype: Any           # resolved torch dtype


def resolve_serve_engine(cfg, serve: Optional[ServeConfig] = None
                         ) -> ServePlan:
    """Map (ModelConfig, ServeConfig) to a serving plan.  Encoder-decoder
    models are rejected here: their per-request cross-attention memory
    does not fit the slot-major self-attention cache."""
    serve = serve if serve is not None else ServeConfig()
    if cfg.arch_type == "encdec":
        raise ValueError(
            "arch_type='encdec' cannot be served by the slot-major decode "
            "cache: each request carries its own cross-attention memory. "
            "Serve a decoder-only arch.")
    if serve.max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if serve.max_seq < 2:
        raise ValueError("max_seq must be >= 2 (prompt + generation)")
    batching = serve.batching  # reprolint: disable=RPL102
    engine_cls = (ContinuousServeEngine if batching == "continuous"
                  else StaticServeEngine)
    timer = (MeasuredTimer()
             if serve.timing == "measured"  # reprolint: disable=RPL102
             else ModelTimer(serve.prefill_cost_ms, serve.decode_cost_ms,
                             serve.slot_cost_ms))
    return ServePlan(
        engine_cls=engine_cls,
        batching=batching,
        requested=batching,
        timer=timer,
        slots=serve.slots,
        max_seq=serve.max_seq,
        max_new_tokens=serve.max_new_tokens,
        cache_dtype=(torch.bfloat16 if serve.cache_dtype == "bfloat16"
                     else torch.float32),
    )


def make_serve_engine(params, cfg, serve: Optional[ServeConfig] = None,
                      device="cuda") -> "ServeEngine":
    """Resolve + instantiate in one call, on ``device``."""
    plan = resolve_serve_engine(cfg, serve)
    return plan.engine_cls(params, cfg, plan, device=device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------
class ServeEngine:
    """Base engine: owns the slot-major ``DecodeCache`` and the four
    primitives (prefill / insert / evict / decode).  ``prefill_calls`` and
    ``decode_calls`` count the forward passes it ran."""

    batching = "base"

    @torch.inference_mode()
    def __init__(self, params, cfg, plan: ServePlan, device="cuda"):
        self.device = resolve_device(device)
        for leaf in _leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"params lie on {leaf.device}, the engine "
                                 f"on {self.device}")
        self.cfg = cfg
        self.plan = plan
        self.params = lm.compute_params(params, cfg)
        self.cache = lm.init_cache(plan.slots, plan.max_seq, cfg,
                                   dtype=plan.cache_dtype, device=self.device)
        self.prefill_calls = 0
        self.decode_calls = 0

    def _tokens(self, tokens):
        return torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)

    def _prefill(self, tokens):
        return lm.prefill(self.params, tokens, self.cfg,
                          cache_dtype=self.plan.cache_dtype)

    def _decode(self, tokens):
        return lm.decode_step(self.params, self.cache, None, tokens, self.cfg)

    # -- primitives behind the plan's timer ----------------------------
    @torch.inference_mode()
    def prefill(self, tokens):
        """Whole-prompt forward in one call.
        tokens: (B, P) int → (last-logits (B,1,V), cache slice, ms)."""
        tokens = self._tokens(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        self.prefill_calls += 1
        (logits, sl), ms = self.plan.timer.call(
            "prefill", tokens.shape[1], self._prefill, tokens)
        return logits, sl, ms

    @torch.inference_mode()
    def insert(self, slice_, slot: int, row: int = 0) -> float:
        """Copy ``row`` of a prefill slice into ``slot``; returns ms."""
        self.cache, ms = self.plan.timer.call(
            "slot", 1, lm.cache_insert, self.cache, slice_, slot, row)
        return ms

    @torch.inference_mode()
    def evict(self, slot: int) -> float:
        """Free ``slot`` (length → 0; payload masked out); returns ms."""
        self.cache, ms = self.plan.timer.call(
            "slot", 1, lm.cache_evict, self.cache, slot)
        return ms

    @torch.inference_mode()
    def decode(self, tokens):
        """One decode step for the whole resident batch: every occupied
        slot advances at its own length.  tokens: (slots,) int (free
        slots' entries are ignored).  Returns (logits (slots,1,V), ms)."""
        tokens = self._tokens(tokens).reshape(self.plan.slots, 1)
        self.decode_calls += 1
        (logits, self.cache), ms = self.plan.timer.call(
            "decode", 1, self._decode, tokens)
        return logits, ms

    def generate(self, prompts, gen: int):
        """Greedy-decode ``gen`` tokens for a (B, P) prompt batch.
        Returns (B, gen) int32 numpy.  B must fit the slot capacity."""
        prompts = np.asarray(prompts, np.int32)
        B = prompts.shape[0]
        if B > self.plan.slots:
            raise ValueError(f"batch {B} exceeds slot capacity "
                             f"{self.plan.slots}")
        logits, sl, _ = self.prefill(prompts)
        for b in range(B):
            self.insert(sl, slot=b, row=b)
        tok = np.zeros((self.plan.slots,), np.int32)
        tok[:B] = logits[:, -1].argmax(dim=-1).cpu().numpy()
        out = [tok[:B].copy()]
        for _ in range(gen - 1):
            logits, _ = self.decode(tok)
            tok[:B] = logits[:B, 0].argmax(dim=-1).cpu().numpy()
            out.append(tok[:B].copy())
        for b in range(B):
            self.evict(b)
        return np.stack(out, axis=1)

    # -- request-stream surface ----------------------------------------
    def run(self, requests) -> Iterator[ServeEvent]:
        raise NotImplementedError

    def _budget(self, req: Request) -> int:
        g = req.max_new_tokens or self.plan.max_new_tokens
        p = len(req.tokens)
        if p + g > self.plan.max_seq:
            raise ValueError(
                f"request {req.id}: prompt {p} + max_new_tokens {g} "
                f"exceeds max_seq {self.plan.max_seq}")
        return g

    def _admit(self, req: Request, slot: int, clock: float):
        """Prefill + insert one request into ``slot``.  Returns
        (new_clock, events, state); state is None when the request
        completed at prefill (budget of exactly one token)."""
        budget = self._budget(req)
        logits, sl, pre_ms = self.prefill(np.asarray(req.tokens)[None])
        clock += pre_ms
        clock += self.insert(sl, slot)
        first = int(logits[0, -1].argmax())
        ttft = clock - req.arrival_ms
        events = [ServeEvent(kind="prefill", request=req.id, t_ms=clock,
                             slot=slot, token=first, prefill_ms=pre_ms,
                             ttft_ms=ttft)]
        state = {"req": req, "toks": [first], "budget": budget,
                 "ttft": ttft}
        if budget == 1:
            clock += self.evict(slot)
            events.append(ServeEvent(
                kind="complete", request=req.id, t_ms=clock, slot=slot,
                ttft_ms=ttft, latency_ms=clock - req.arrival_ms,
                tokens=state["toks"]))
            state = None
        return clock, events, state


class ContinuousServeEngine(ServeEngine):
    """Continuous batching: between decode steps, every arrived request
    takes a free slot immediately; completed requests evict their slot
    mid-flight, so the decode batch never drains to re-form."""

    batching = "continuous"

    def run(self, requests) -> Iterator[ServeEvent]:
        stream = iter(requests)
        nxt = next(stream, None)
        free = SlotAllocator(self.plan.slots)
        resident = {}                      # slot -> admission state
        last_tok = np.zeros((self.plan.slots,), np.int32)
        clock = 0.0
        while nxt is not None or resident:
            while (nxt is not None and free.available
                   and nxt.arrival_ms <= clock):
                slot = free.alloc()
                yield ServeEvent(kind="arrival", request=nxt.id,
                                 t_ms=nxt.arrival_ms, slot=slot)
                clock, events, state = self._admit(nxt, slot, clock)
                yield from events
                if state is None:
                    free.free(slot)
                else:
                    resident[slot] = state
                    last_tok[slot] = state["toks"][-1]
                nxt = next(stream, None)
            if not resident:
                if nxt is None:
                    break
                clock = max(clock, nxt.arrival_ms)   # idle: jump to arrival
                continue
            logits, dec_ms = self.decode(last_tok)
            clock += dec_ms
            nxt_tok = logits[:, 0].argmax(dim=-1).cpu().numpy()
            for slot in sorted(resident):
                st = resident[slot]
                tok = int(nxt_tok[slot])
                st["toks"].append(tok)
                last_tok[slot] = tok
                yield ServeEvent(kind="token", request=st["req"].id,
                                 t_ms=clock, slot=slot, token=tok,
                                 decode_ms=dec_ms)
                if len(st["toks"]) >= st["budget"]:
                    clock += self.evict(slot)
                    yield ServeEvent(
                        kind="complete", request=st["req"].id, t_ms=clock,
                        slot=slot, ttft_ms=st["ttft"],
                        latency_ms=clock - st["req"].arrival_ms,
                        tokens=st["toks"])
                    del resident[slot]
                    free.free(slot)


class StaticServeEngine(ServeEngine):
    """Static batching baseline: requests form fixed groups of ``slots``;
    a group starts once its last member has arrived, and the whole group
    decodes until every member is done before the next group forms."""

    batching = "static"

    def run(self, requests) -> Iterator[ServeEvent]:
        reqs = list(requests)
        clock = 0.0
        for start in range(0, len(reqs), self.plan.slots):
            group = reqs[start:start + self.plan.slots]
            for slot, req in enumerate(group):
                yield ServeEvent(kind="arrival", request=req.id,
                                 t_ms=req.arrival_ms, slot=slot)
            clock = max(clock, max(r.arrival_ms for r in group))
            resident = {}
            last_tok = np.zeros((self.plan.slots,), np.int32)
            for slot, req in enumerate(group):
                clock, events, state = self._admit(req, slot, clock)
                yield from events
                if state is not None:
                    resident[slot] = state
                    last_tok[slot] = state["toks"][-1]
            while resident:
                logits, dec_ms = self.decode(last_tok)
                clock += dec_ms
                nxt_tok = logits[:, 0].argmax(dim=-1).cpu().numpy()
                for slot in sorted(resident):
                    st = resident[slot]
                    tok = int(nxt_tok[slot])
                    st["toks"].append(tok)
                    last_tok[slot] = tok
                    yield ServeEvent(kind="token", request=st["req"].id,
                                     t_ms=clock, slot=slot, token=tok,
                                     decode_ms=dec_ms)
                    if len(st["toks"]) >= st["budget"]:
                        yield ServeEvent(
                            kind="complete", request=st["req"].id,
                            t_ms=clock, slot=slot, ttft_ms=st["ttft"],
                            latency_ms=clock - st["req"].arrival_ms,
                            tokens=st["toks"])
                        del resident[slot]
            for slot, _ in enumerate(group):
                clock += self.evict(slot)
