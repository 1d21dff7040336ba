"""Minimal discrete-event simulation kernel (SimPy-flavoured, generator processes).

The storage substrate of the HHZS reproduction runs on virtual time: devices
are FIFO resources, foreground clients and background jobs (flush, compaction,
migration) are generator processes that ``yield`` events.  This keeps the
LSM-tree / HHZS logic an exact, inspectable reproduction of the paper's
control flow while producing throughput / latency numbers from the device
timing model (Table 1 of the paper).

Daemon events: periodic background pollers (migration ticks, AUTO's
throughput monitor) schedule *daemon* timeouts that do not keep ``run()``
alive — ``run()`` returns once only daemon events remain, i.e. when all real
work (client ops, flush/compaction/migration I/O) has settled.

Hot-path design (benchmarked by ``benchmarks/sim_speed.py``):

* **Slim entries.**  A scheduled entry is a plain tuple ending in
  ``(event, value)``: dispatch fires ``event.succeed(value)`` inline, so
  ``timeout()`` allocates no per-entry closure (the seed kernel built a
  lambda per scheduled event).
* **Single-waiter fast path.**  Almost every event has exactly one waiter
  (the process step that yielded it).  ``Event`` keeps that one callback in
  a dedicated ``_cb`` slot and only allocates a waiter list on the second
  subscriber.
* **Monotone run queue.**  DES schedules are overwhelmingly time-ordered:
  the kernel keeps a global deque of entries whose fire times never
  decrease (O(1) append / O(1) pop) and only out-of-order entries touch
  the binary heap.  Dispatch merges the heap head with every queue head by
  ``(time, seq)``, reproducing exactly the order per-entry heap scheduling
  would have produced.
* **Per-device completion batches.**  A FIFO busy-until resource completes
  I/O in nondecreasing time order, so ``ZonedDevice`` gives each service
  track its own :class:`MonotoneQueue` (the ``fifo_device`` bench shape):
  completions never contend with the global schedule for heap space.
* **Bare-delay yields.**  A process may yield a plain ``float``/``int``
  delay instead of ``timeout()``: the kernel schedules its resume callback
  directly — no Event is allocated at all (the ``process_chain`` /
  ``sem_pool`` / ``daemon_mix`` bench shapes; used by production sleeps).
* **Bulk insert.**  ``schedule_many()`` schedules a whole batch of timeouts
  as a one-shot monotone queue in O(n) when the batch is nondecreasing
  (the ``timer_churn`` bench shape), and via one O(n + h) ``heapify``
  otherwise — vs O(n log n) for n individual ``timeout()`` calls.
"""
from __future__ import annotations

import numbers

from heapq import heapify, heappop, heappush
from typing import Any, Callable, Generator, Iterable, List, Optional

from collections import deque

# written into a completion ticket's waiter slot when it fires unawaited:
# a process that yields the ticket afterwards resumes immediately (the
# moral equivalent of yielding an already-triggered Event)
_FIRED = object()

_INF = float("inf")


class Event:
    """One-shot event; processes wait on it by ``yield``-ing it.

    ``_cb`` is the single-waiter fast path; ``_waiters`` is lazily created
    only when a second callback subscribes before the event triggers.
    """

    __slots__ = ("sim", "triggered", "value", "_cb", "_waiters")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.triggered = False
        self.value: Any = None
        self._cb: Optional[Callable[[Any], None]] = None
        self._waiters: Optional[List[Callable[[Any], None]]] = None

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.value = value
        cb = self._cb
        if cb is not None:
            self._cb = None
            cb(value)
        waiters = self._waiters
        if waiters is not None:
            self._waiters = None
            for w in waiters:
                w(value)
        return self

    def add_callback(self, cb: Callable[[Any], None]) -> None:
        if self.triggered:
            cb(self.value)
        elif self._cb is None:
            self._cb = cb
        elif self._waiters is None:
            self._waiters = [cb]
        else:
            self._waiters.append(cb)


class Process(Event):
    """Drives a generator; the Process itself is an Event that fires on return.

    A process yields either an :class:`Event` to wait on, or a bare
    real-number delay — sugar for ``timeout(delay)`` that skips the Event
    allocation entirely (the kernel resumes the generator directly).
    ``float``/``int`` take the fast path; any other ``numbers.Real``
    (numpy scalars like ``np.float64(0.25)``) is accepted via a
    conversion fallback.
    """

    __slots__ = ("gen", "_send", "_bound_step")

    def __init__(self, sim: "Sim", gen: Generator):
        # inlined Event.__init__ + immediate-start scheduling (process
        # creation is a hot allocation site for job-per-op pools)
        self.sim = sim
        self.triggered = False
        self.value = None
        self._cb = None
        self._waiters = None
        self.gen = gen
        self._send = gen.send
        # bind once: `self._step` attribute access builds a fresh bound
        # method per yield, which shows up in the hot loop
        step = self._bound_step = self._step
        now = sim.now
        sim._seq += 1
        sim._live += 1
        entry = (now, sim._seq, step, None)
        rq = sim._rq
        if rq._q and now < rq._last:
            heappush(sim._heap, (now, sim._seq, False, step, None))
        else:
            rq._q.append(entry)
            rq._last = now

    def _step(self, send_value: Any) -> None:
        try:
            ev = self._send(send_value)
        except StopIteration as stop:
            self.succeed(stop.value)
            return
        cls = ev.__class__
        if cls is Event:
            # inlined Event.add_callback (single-waiter fast path)
            if ev.triggered:
                self._bound_step(ev.value)
            elif ev._cb is None:
                ev._cb = self._bound_step
            elif ev._waiters is None:
                ev._waiters = [self._bound_step]
            else:
                ev._waiters.append(self._bound_step)
            return
        if cls is list:
            # completion ticket (MonotoneQueue.complete_at): write the
            # resume callback straight into the pending entry
            w = ev[2]
            if w is None:
                ev[2] = self._bound_step
            elif w is _FIRED:
                # already completed (the caller yielded other events
                # first): resume immediately, like a triggered Event
                self._bound_step(ev[3])
            else:
                raise RuntimeError("completion ticket already awaited")
            return
        if cls is float or cls is int:
            # bare delay: schedule the resume directly, no Event allocated
            if ev < 0:
                raise ValueError(f"negative delay {ev}")
            sim = self.sim
            at = sim.now + ev
            sim._seq += 1
            sim._live += 1
            rq = sim._rq
            if rq._q and at < rq._last:
                heappush(sim._heap,
                         (at, sim._seq, False, self._bound_step, None))
            else:
                rq._q.append((at, sim._seq, self._bound_step, None))
                rq._last = at
            return
        if isinstance(ev, Event):   # Event subclass (e.g. joining a Process)
            ev.add_callback(self._bound_step)
            return
        if isinstance(ev, numbers.Real):
            # any real number is a bare delay: numpy scalars
            # (np.float64(0.25), np.int64(1)) and other Real duck-types
            # are not `float`/`int` exactly, so they miss the fast path
            # above — convert once and take the same no-Event schedule
            delay = float(ev)
            if delay < 0:
                raise ValueError(f"negative delay {delay}")
            sim = self.sim
            at = sim.now + delay
            sim._seq += 1
            sim._live += 1
            rq = sim._rq
            if rq._q and at < rq._last:
                heappush(sim._heap,
                         (at, sim._seq, False, self._bound_step, None))
            else:
                rq._q.append((at, sim._seq, self._bound_step, None))
                rq._last = at
            return
        raise TypeError(
            f"process yielded non-event: {ev!r} — yield an Event, a device "
            f"completion ticket, or a real-number delay (float/int/numpy "
            f"scalar)")


class Sim:
    """Event loop over virtual seconds.

    Dispatch state lives in three places, merged by ``(time, seq)``:

    * ``_heap``   — out-of-order and daemon entries:
      ``(at, seq, daemon, target, value)``
    * ``_rq``     — the global monotone run queue (in-order entries)
    * ``_mono``   — attached device queues and one-shot batches;
      entries in all queues are ``(at, seq, target, value)``

    A ``target`` is either an :class:`Event` (fired inline) or a bare
    callback (a suspended process's resume; called directly).
    """

    # processes may `yield <float>` instead of `yield timeout(<float>)`
    # (feature-detected by benchmarks/sim_speed.py against the seed kernel)
    BARE_DELAY_YIELDS = True

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: List[tuple] = []
        self._seq = 0
        self._live = 0  # non-daemon entries across heap + queues
        self._mono: List["MonotoneQueue"] = []  # run queue + device queues
        self._mono_ver = 0     # bumped on attach/prune; dispatch re-hoists
        self._n_transient = 0  # one-shot schedule_many batches in _mono
        self._rq = MonotoneQueue(self)          # global monotone run queue
        # crash support (DB.crash): events/processes killed by a simulated
        # power loss are pinned here so CPython never finalizes their
        # suspended generators — GeneratorExit would run their `finally`
        # blocks (semaphore releases, waiter wake-ups), resurrecting other
        # dead processes after the crash
        self.graveyard: List = []

    # -- scheduling -------------------------------------------------------
    def timeout(self, delay: float, value: Any = None,
                daemon: bool = False) -> Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        # inlined Event() + scheduling: timeout is the kernel's hottest
        # allocation site (one per I/O, per yield, per poller tick)
        ev = Event.__new__(Event)
        ev.sim = self
        ev.triggered = False
        ev.value = None
        ev._cb = None
        ev._waiters = None
        at = self.now + delay
        self._seq += 1
        if daemon:
            heappush(self._heap, (at, self._seq, True, ev, value))
            return ev
        self._live += 1
        rq = self._rq
        if rq._q and at < rq._last:
            heappush(self._heap, (at, self._seq, False, ev, value))
        else:
            rq._q.append((at, self._seq, ev, value))
            rq._last = at
        return ev

    def schedule_at(self, at: float, value: Any = None,
                    daemon: bool = False) -> Event:
        """Schedule an event at *absolute* virtual time ``at`` (>= now).

        Unlike ``timeout(at - now)`` this fires at exactly ``at`` — no
        float round-trip through a delay — which is what lets the batched
        and unbatched device paths produce bit-identical completion times.
        """
        if at < self.now:
            raise ValueError(f"schedule_at({at}) is in the past ({self.now})")
        ev = Event.__new__(Event)
        ev.sim = self
        ev.triggered = False
        ev.value = None
        ev._cb = None
        ev._waiters = None
        self._seq += 1
        if not daemon:
            self._live += 1
        heappush(self._heap, (at, self._seq, daemon, ev, value))
        return ev

    def schedule_many(self, delays: Iterable[float], value: Any = None,
                      daemon: bool = False) -> List[Event]:
        """Bulk-insert a batch of timeouts; returns their Events in order.

        A nondecreasing non-daemon batch is stored as a one-shot
        :class:`MonotoneQueue` (O(n) to build, O(1) per dispatch, zero
        heap traffic — the pre-scheduled sweep shape); any other batch
        lands on the heap via one O(n + h) ``heapify`` — vs
        O(n log(n + h)) for n individual ``timeout()`` calls.  Semantics
        (ordering, daemon flag, returned Events) are identical to calling
        ``timeout`` once per delay.
        """
        now = self.now
        seq = self._seq
        new = Event.__new__
        entries: List[tuple] = []
        append = entries.append
        prev = float("-inf")
        in_order = True
        for d in delays:
            if d < 0:
                raise ValueError(f"negative delay {d}")
            at = now + d
            seq += 1
            ev = new(Event)
            ev.sim = self
            ev.triggered = False
            ev.value = None
            ev._cb = None
            ev._waiters = None
            append((at, seq, ev, value))
            if at < prev:
                in_order = False
            prev = at
        self._seq = seq
        if not daemon:
            self._live += len(entries)
        if entries and in_order and not daemon:
            # one-shot completion batch: dispatched straight off a deque,
            # merged with the heap by (time, seq); pruned once drained
            q = MonotoneQueue(self, transient=True)
            q._q.extend(entries)
            q._last = entries[-1][0]
            self._n_transient += 1
        else:
            heap = self._heap
            heap.extend((at, sq, daemon, ev, v)
                        for at, sq, ev, v in entries)
            heapify(heap)
        return [e[2] for e in entries]

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def monotone_queue(self) -> "MonotoneQueue":
        """Attach a new per-device completion batch (see MonotoneQueue)."""
        return MonotoneQueue(self)

    def _prune_transient(self) -> None:
        """Drop drained one-shot schedule_many batches from the merge scan."""
        kept = [q for q in self._mono if not (q.transient and not q._q)]
        self._n_transient -= len(self._mono) - len(kept)
        self._mono = kept
        self._mono_ver += 1

    # -- running ----------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        """Run until no *non-daemon* work remains (or virtual ``until``).

        ``until`` never moves time backwards: a target already in the past
        is a no-op (virtual time is monotonic; rewinding it would corrupt
        every timestamp captured afterwards)."""
        if self._n_transient:
            self._prune_transient()
        heap = self._heap
        # deque identities are stable, so hoist them out of the merge scan:
        # the run queue is scanned unrolled (it is always present), device
        # queues / transient batches land in `others` (usually empty or
        # tiny); the version guard re-hoists if a queue attaches mid-run
        ver = self._mono_ver
        rdq = self._rq._q
        others = [q._q for q in self._mono if q is not self._rq]
        while self._live > 0:
            if self._mono_ver != ver:
                ver = self._mono_ver
                others = [q._q for q in self._mono if q is not self._rq]
            # pick the earliest source by (time, seq)
            src: Optional[deque] = None    # None -> heap
            if heap:
                head = heap[0]
                at = head[0]
                sq = head[1]
            else:
                at = _INF
                sq = 0
            if rdq:
                e = rdq[0]
                eat = e[0]
                if eat < at or (eat == at and e[1] < sq):
                    at = eat
                    sq = e[1]
                    src = rdq
            if others:
                for dq in others:
                    if dq:
                        e = dq[0]
                        eat = e[0]
                        if eat < at or (eat == at and e[1] < sq):
                            at = eat
                            sq = e[1]
                            src = dq
            if at == _INF:
                break
            if until is not None and at > until:
                if until > self.now:
                    self.now = until
                return
            self.now = at
            if src is None:
                _, _, daemon, ev, value = heappop(heap)
                if not daemon:
                    self._live -= 1
            else:
                entry = src.popleft()
                self._live -= 1
                if entry.__class__ is list:
                    ev = entry[2]
                    value = entry[3]
                    entry[2] = _FIRED   # late yields resume immediately
                else:
                    _, _, ev, value = entry
            # fire: an Event succeeds inline; a bare callback (process
            # resume from a bare-delay yield or a completion ticket) is
            # called directly; None is an un-awaited ticket (no waiter)
            if ev.__class__ is Event:
                if ev.triggered:
                    raise RuntimeError("event already triggered")
                ev.triggered = True
                ev.value = value
                cb = ev._cb
                if cb is not None:
                    ev._cb = None
                    cb(value)
                ws = ev._waiters
                if ws is not None:
                    ev._waiters = None
                    for w in ws:
                        w(value)
            elif ev is not None:
                ev(value)
        if until is not None and until > self.now:
            self.now = until

    def run_until(self, ev: Event) -> Any:
        """Run until ``ev`` triggers (used by the synchronous KV facade)."""
        if self._n_transient:
            self._prune_transient()
        heap = self._heap
        ver = self._mono_ver
        rdq = self._rq._q
        others = [q._q for q in self._mono if q is not self._rq]
        daemon_only = 0
        while not ev.triggered:
            if self._mono_ver != ver:
                ver = self._mono_ver
                others = [q._q for q in self._mono if q is not self._rq]
            src: Optional[deque] = None    # None -> heap
            if heap:
                head = heap[0]
                at = head[0]
                sq = head[1]
            else:
                at = _INF
                sq = 0
            if rdq:
                e = rdq[0]
                eat = e[0]
                if eat < at or (eat == at and e[1] < sq):
                    at = eat
                    sq = e[1]
                    src = rdq
            if others:
                for dq in others:
                    if dq:
                        e = dq[0]
                        eat = e[0]
                        if eat < at or (eat == at and e[1] < sq):
                            at = eat
                            sq = e[1]
                            src = dq
            if at == _INF:
                raise RuntimeError("deadlock: event never triggers")
            if self._live == 0:
                daemon_only += 1
                if daemon_only > 1_000_000:
                    raise RuntimeError(
                        "livelock: only daemon events remain but the "
                        "awaited event never triggers")
            else:
                daemon_only = 0
            if src is None:
                _, _, daemon, e, value = heappop(heap)
                if not daemon:
                    self._live -= 1
            else:
                entry = src.popleft()
                self._live -= 1
                if entry.__class__ is list:
                    e = entry[2]
                    value = entry[3]
                    entry[2] = _FIRED   # late yields resume immediately
                else:
                    _, _, e, value = entry
            self.now = at
            # fire (hot: one per client op yield) — see run()
            if e.__class__ is Event:
                if e.triggered:
                    raise RuntimeError("event already triggered")
                e.triggered = True
                e.value = value
                cb = e._cb
                if cb is not None:
                    e._cb = None
                    cb(value)
                ws = e._waiters
                if ws is not None:
                    e._waiters = None
                    for w in ws:
                        w(value)
            elif e is not None:
                e(value)
        return ev.value


class MonotoneQueue:
    """A batch of scheduled entries whose fire times never decrease.

    Three users share this shape:

    * the Sim's built-in global run queue (``Sim._rq``): ``timeout()`` and
      bare-delay yields land here whenever their fire time is >= the tail;
    * per-device completion batches (``ZonedDevice`` service tracks): a
      FIFO busy-until resource completes I/O in nondecreasing time, so its
      completions always ride the O(1) deque;
    * one-shot ``schedule_many`` batches (``transient=True``), pruned from
      the merge scan once drained.

    Entries are ``(at, seq, target, value)`` and are never daemon; the
    dispatch loops merge every queue head against the heap head by
    ``(time, seq)``, so global order is exactly what per-entry heap
    scheduling would have produced.  ``schedule_at`` falls back to a plain
    heap entry whenever the monotonicity invariant would break (e.g. after
    ``ZonedDevice.restart()`` mid-crash) — correctness never depends on
    the invariant, only the O(1) fast path does.
    """

    __slots__ = ("sim", "_q", "_last", "transient")

    def __init__(self, sim: Sim, transient: bool = False):
        self.sim = sim
        self._q: deque = deque()   # (at, seq, target, value), nondecreasing
        self._last = 0.0           # newest pending time (valid while busy)
        self.transient = transient
        sim._mono.append(self)
        sim._mono_ver += 1

    def schedule_at(self, at: float, value: Any = None) -> Event:
        """Schedule a completion at absolute time ``at`` (>= sim.now)."""
        sim = self.sim
        if at < sim.now:
            raise ValueError(f"schedule_at({at}) is in the past ({sim.now})")
        if self._q and at < self._last:
            # non-monotone (device restarted under pending completions):
            # take the exact-same-time heap path
            return sim.schedule_at(at, value)
        ev = Event.__new__(Event)
        ev.sim = sim
        ev.triggered = False
        ev.value = None
        ev._cb = None
        ev._waiters = None
        sim._seq += 1
        sim._live += 1
        self._q.append((at, sim._seq, ev, value))
        self._last = at
        return ev

    def complete_at(self, at: float, value: Any = None) -> Any:
        """Schedule a completion *ticket* at absolute time ``at``.

        The ticket is the pending entry itself (a mutable
        ``[at, seq, waiter, value]`` list): a process that ``yield``-s it
        gets its resume callback written straight into slot 2 — no Event
        is allocated and dispatch calls the waiter directly.  A ticket
        nobody awaits completes silently; one first yielded *after* its
        completion fired resumes the process immediately (like yielding
        an already-triggered Event).  Use :meth:`schedule_at` when the
        caller needs a real Event (``add_callback``, multiple waiters).
        """
        sim = self.sim
        if at < sim.now:
            raise ValueError(f"complete_at({at}) is in the past ({sim.now})")
        if self._q and at < self._last:
            # non-monotone (device restarted under pending completions):
            # same absolute fire time through the heap, as a real Event
            return sim.schedule_at(at, value)
        sim._seq += 1
        sim._live += 1
        entry = [at, sim._seq, None, value]
        self._q.append(entry)
        self._last = at
        return entry

    def crash_clear(self) -> List[tuple]:
        """Drop every pending completion (power loss); returns the dropped
        entries so ``DB.crash`` can pin them in the graveyard."""
        dead = list(self._q)
        self._q.clear()
        self.sim._live -= len(dead)
        return dead


class Semaphore:
    """Counting semaphore for background job thread pools."""

    def __init__(self, sim: Sim, capacity: int):
        self.sim = sim
        self.capacity = capacity
        self.in_use = 0
        self._queue: deque = deque()

    def acquire(self) -> Event:
        # inlined Event(): one acquire per background job makes this hot
        ev = Event.__new__(Event)
        ev.sim = self.sim
        ev.value = None
        ev._cb = None
        ev._waiters = None
        if self.in_use < self.capacity:
            self.in_use += 1
            ev.triggered = True    # immediate grant: nobody subscribed yet
        else:
            ev.triggered = False
            self._queue.append(ev)
        return ev

    def release(self) -> None:
        q = self._queue
        if q:
            # inlined Event.succeed (one grant per queued background job)
            ev = q.popleft()
            ev.triggered = True
            cb = ev._cb
            if cb is not None:
                ev._cb = None
                cb(None)
            ws = ev._waiters
            if ws is not None:
                ev._waiters = None
                for w in ws:
                    w(None)
        else:
            self.in_use -= 1
            if self.in_use < 0:
                raise RuntimeError("semaphore released below zero")
