"""Serving substrate: continuous batching + straggler mitigation.

Port of ``repro.serving.batching``.  Requests join a waiting queue; each
engine step assembles a fixed-size batch (continuous batching: a finished
request's slot is refilled next step).  A request whose worker misses its
deadline is hedged — re-enqueued at the front for the next step; the first
completion wins, the duplicate is dropped (idempotent by request id).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core.query import (Query, QueryResult, execute_query,
                                    stack_queries)


@dataclass(order=True)
class Request:
    priority: float
    rid: int = field(compare=False)
    payload: Any = field(compare=False)
    enqueued_at: float = field(compare=False, default=0.0)
    deadline_ms: float = field(compare=False, default=100.0)
    started_at: float = field(compare=False, default=0.0)
    hedged: bool = field(compare=False, default=False)


@dataclass
class BatchScheduler:
    batch_size: int
    step_fn: Callable[[list], list]       # batch of payloads -> results
    hedge_after_ms: float = 50.0
    waiting: list = field(default_factory=list)   # heap by priority
    running: dict = field(default_factory=dict)   # rid -> Request
    done: dict = field(default_factory=dict)      # rid -> result
    hedge_count: int = 0
    _next_rid: int = 0

    def submit(self, payload, *, priority: float = 1.0,
               deadline_ms: float = 100.0) -> int:
        rid = self._next_rid
        self._next_rid += 1
        heapq.heappush(self.waiting, Request(
            priority=-priority, rid=rid, payload=payload,
            enqueued_at=time.perf_counter(), deadline_ms=deadline_ms))
        return rid

    def _hedge_stragglers(self, now):
        for rid, req in list(self.running.items()):
            if (now - req.started_at) * 1e3 > self.hedge_after_ms \
                    and not req.hedged:
                req.hedged = True
                self.hedge_count += 1
                heapq.heappush(self.waiting, Request(
                    priority=-1e9, rid=rid, payload=req.payload,
                    enqueued_at=now, deadline_ms=req.deadline_ms))

    def step(self) -> dict:
        """One engine iteration: fill the batch, run, retire completions."""
        now = time.perf_counter()
        self._hedge_stragglers(now)
        batch = []
        while self.waiting and len(batch) < self.batch_size:
            req = heapq.heappop(self.waiting)
            if req.rid in self.done:      # hedged duplicate already served
                continue
            req.started_at = now
            self.running[req.rid] = req
            batch.append(req)
        if not batch:
            return {}
        results = self.step_fn([r.payload for r in batch])
        out = {}
        for req, res in zip(batch, results):
            if req.rid not in self.done:  # first completion wins
                self.done[req.rid] = res
                out[req.rid] = res
            self.running.pop(req.rid, None)
        return out

    def drain(self, max_steps: int = 10_000) -> dict:
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            self.step()
        return self.done


class PendingResult:
    """A query result whose sweep has been issued but not read back.

    ``make_query_step_fn(block=False)`` stores one per request in
    ``BatchScheduler.done``: the group's batched result stays in device
    tensors, and the caller resolves rows after one synchronize instead of
    a host read inside every scheduler step.  ``resolve`` is idempotent and
    returns exactly what the blocking path would have."""

    __slots__ = ("_res", "_i", "_legacy", "_out")

    def __init__(self, res, i: int, legacy: bool):
        self._res, self._i, self._legacy = res, i, legacy
        self._out = None

    def resolve(self):
        if self._out is None:
            self._out = _row(self._res, self._i, self._legacy)
            self._res = None           # release the batched device tensors
        return self._out


def _row(res: QueryResult, i: int, legacy: bool):
    """Row i of a batched result, on the host: (oid, score) of the top hit
    for a legacy payload, else the row's QueryResult of numpy arrays."""
    oids = res.oids[i].cpu().numpy()
    scores = res.scores[i].cpu().numpy()
    if legacy:
        return int(oids[0]), float(scores[0])
    return QueryResult(oids=oids, scores=scores,
                       slots=res.slots[i].cpu().numpy())


def resolve_results(done: dict) -> dict:
    """Materialize every PendingResult in a scheduler's ``done`` dict (in
    place)."""
    for rid, r in done.items():
        if isinstance(r, PendingResult):
            done[rid] = r.resolve()
    return done


def make_query_step_fn(get_map, *, k: int = 5, use_pallas: bool = False,
                       pad_to: int | None = None, block: bool = True,
                       get_index=None):
    """Build a BatchScheduler ``step_fn`` over the declarative query engine.

    Payloads are ``core.query.Query`` specs; a raw [E] embedding is a
    legacy payload, read as ``Query(embed=..., k=k)``.  Each step groups
    the specs by plan (``Query.static()`` and which dynamic fields are
    set), stacks each group into one batched spec padded to ``pad_to``, and
    runs one ``execute_query`` per group over ``get_map()`` (through
    ``get_index()`` when given: both are re-read every step).

    Returns, in payload order, ``(oid, score)`` of the top hit for legacy
    payloads or the request's ``QueryResult`` row (numpy) for Query
    payloads; with ``block=False``, ``PendingResult`` handles holding the
    device tensors instead.  ``use_pallas`` is accepted and ignored.
    """
    del use_pallas

    def step_fn(payloads: list) -> list:
        m = get_map()
        index = get_index() if get_index is not None else None
        legacy = [not isinstance(p, Query) for p in payloads]
        specs = [Query(embed=torch.as_tensor(p), k=k) if leg else p
                 for p, leg in zip(payloads, legacy)]
        groups: dict = {}
        for pos, s in enumerate(specs):
            key = (s.static(), tuple(s.dynamic()))
            groups.setdefault(key, []).append(pos)
        results: list = [None] * len(specs)
        for positions in groups.values():
            width = max(pad_to or 0, len(positions))
            batched = stack_queries([specs[p] for p in positions],
                                    pad_to=width)
            res = execute_query(m, batched, index=index)
            if block:                    # one host read for the group
                res = QueryResult(*(x.cpu() for x in res))
            for i, pos in enumerate(positions):
                results[pos] = _row(res, i, legacy[pos]) if block \
                    else PendingResult(res, i, legacy[pos])
        return results

    return step_fn
