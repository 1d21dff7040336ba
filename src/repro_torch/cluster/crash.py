"""Surgical per-shard crash on a shared DES clock.

``DB.crash()`` models whole-store power loss: it clears the entire event
heap, every device queue and ``sim._live`` — correct for one store, but a
cluster shares ONE :class:`~repro_torch.zoned.sim.Sim` across N shard stores
plus cluster-level machinery (workload servers, the metrics sampler,
fault daemons, an in-flight split).  Killing one shard must not touch
any of that, and the kernel is deliberately ignorant of shards.

The trick: *at crash time only* (zero hot-path cost), classify every
pending kernel entry by walking the ``yield from`` frame chain of the
process it would resume.  A process whose chain is suspended inside any
of the shard's objects (``f_locals["self"]`` is the shard's tree /
backend / device / placement / migrator / ...) is executing shard code —
whether it is a shard daemon (delay controller, migrator, WAL writer,
zone-repair poller) or an external client caught mid-op on the shard.
Both must die with the shard; a client parked on cluster-level state
(admission hold, router park events) or a process of another shard never
has a shard-owned frame and survives untouched.

Removal follows the kernel's own crash discipline (see ``DB.crash``):

* entries are removed **in place** (``deque.clear()+extend``,
  ``heap[:] = kept`` + heapify) — the dispatch loops in ``Sim.run`` /
  ``run_until`` hoist queue objects *by identity* and must keep seeing
  the same containers;
* ``sim._live`` drops by one per removed non-daemon heap entry and per
  removed run-queue/transient entry (mono entries are never daemon);
  the shard's own device queues use ``MonotoneQueue.crash_clear()``,
  which does its own accounting;
* everything removed — entries, wait-list events, the dead processes —
  is pinned in ``sim.graveyard``: dropping the last reference to a
  suspended generator runs its ``finally`` blocks (semaphore releases,
  waiter wake-ups) and would resurrect other dead work, but a power
  loss must not execute any further shard code.

``kill_shard(sim, db)`` leaves ``db`` with ``_crashed=True`` and its
volatile state dropped, so the **untouched** ``DB.reopen_gen()`` replays
the shard's WAL exactly as it would after a whole-store crash.
"""
from __future__ import annotations

from heapq import heapify
from typing import List, Set, Tuple

from ..zoned.sim import _FIRED, Event, Process


def _owned_objects(db) -> Set[int]:
    """Identity set of the shard's layer objects; a generator frame whose
    ``self`` is one of these is executing shard code."""
    be, tree = db.backend, db.tree
    objs = [db, tree, be, db.ssd, db.hdd, db.admission,
            be.placement, be.migrator, be.cache,
            tree.block_cache, tree.jobs]
    return {id(o) for o in objs if o is not None}


def _frame_owned(gen, owned: Set[int]) -> bool:
    """Walk ``gen``'s ``yield from`` delegation chain; True if any frame's
    ``self`` is a shard object."""
    g = gen
    while g is not None:
        f = getattr(g, "gi_frame", None)
        if f is None:          # finished/closed generator: nothing to kill
            return False
        if id(f.f_locals.get("self")) in owned:
            return True
        g = getattr(g, "gi_yieldfrom", None)
    return False


def _target_procs(target) -> Tuple[List[Process], bool]:
    """Processes a kernel entry's target would resume when it fires.

    ``target`` is a heap/queue entry's callback slot: an :class:`Event`
    (collect its ``_cb``/``_waiters`` subscribers), a bare bound
    ``Process._step`` callback, or a completion-ticket waiter slot
    (``None`` / ``_FIRED`` / bound step).  The second element is True
    when a non-Process subscriber exists (unknown party — never kill)."""
    if isinstance(target, Event):
        cbs = []
        if target._cb is not None:
            cbs.append(target._cb)
        if target._waiters:
            cbs.extend(target._waiters)
        procs, unknown = [], False
        for cb in cbs:
            s = getattr(cb, "__self__", None)
            if isinstance(s, Process):
                procs.append(s)
            else:
                unknown = True
        return procs, unknown
    s = getattr(target, "__self__", None)
    if isinstance(s, Process):
        return [s], False
    return [], target is not None and target is not _FIRED


def kill_shard(sim, db) -> List[Process]:
    """Power-loss one shard store in place; returns the killed processes.

    The caller (``ShardedDB.crash_shard``) handles cluster-level
    bookkeeping — routing state, in-flight tokens, split rollback.  The
    returned list lets the workload runner respawn exactly the servers it
    lost (membership by identity)."""
    owned = _owned_objects(db)
    graveyard = sim.graveyard
    killed: List[Process] = []
    seen: Set[int] = set()

    def note(procs: List[Process]) -> None:
        for p in procs:
            if id(p) not in seen:
                seen.add(id(p))
                killed.append(p)

    def entry_dies(target) -> bool:
        procs, unknown = _target_procs(target)
        if unknown or not procs:
            # waiter-less events (nobody subscribed yet) stay: firing with
            # no waiters is a no-op, and a non-shard process may still be
            # about to yield one
            return False
        if all(_frame_owned(p.gen, owned) for p in procs):
            note(procs)
            return True
        return False

    # 1. event heap: (at, seq, daemon, target, value) — daemon entries
    #    (shard pollers) never counted in _live
    kept = []
    for e in sim._heap:
        if entry_dies(e[3]):
            graveyard.append(e)
            if not e[2]:
                sim._live -= 1
        else:
            kept.append(e)
    if len(kept) != len(sim._heap):
        sim._heap[:] = kept
        heapify(sim._heap)

    # 2. run queue + transient batches: (at, seq, target, value) tuples /
    #    [at, seq, waiter, value] tickets, all non-daemon.  The shard's
    #    own device queues are crash_clear()ed wholesale in step 3; other
    #    shards' device tickets can only resume processes suspended in
    #    *their* shard's frames, so scanning them is skipped too.
    shard_devq = {id(q) for dev in (db.ssd, db.hdd)
                  for q in (dev._fg_q, dev._bg_q) if q is not None}
    for q in sim._mono:
        if id(q) in shard_devq or not q._q:
            continue
        kept_q, dropped = [], []
        for e in q._q:
            (dropped if entry_dies(e[2]) else kept_q).append(e)
        if dropped:
            q._q.clear()           # in place: dispatch hoists this deque
            q._q.extend(kept_q)
            graveyard.append(dropped)
            sim._live -= len(dropped)

    # 3. the shard's device queues drain with the power; every waiter was
    #    mid-I/O on this shard and dies (crash_clear adjusts _live itself)
    for dev in (db.ssd, db.hdd):
        for q in (dev._fg_q, dev._bg_q):
            if q is None:
                continue
            dropped = q.crash_clear()
            if dropped:
                graveyard.append(dropped)
                for e in dropped:
                    note(_target_procs(e[2])[0])
        dev.restart()

    # 4. volatile wait lists: stall-parked writers, WAL group-commit
    #    waiters, flush watchers and queued flush/compaction jobs hold
    #    no scheduled entry — their wake-up source just died with the
    #    shard, so pin them (and count their processes as killed)
    be, tree = db.backend, db.tree
    for ev in (list(be._wal_waiters) + list(tree._stall_waiters)
               + list(tree._flush_watchers) + list(tree.jobs._queue)):
        note(_target_procs(ev)[0])
        graveyard.append(ev)
    graveyard.extend([be._wal_waiters, be._wal_queue,
                      tree._stall_waiters, tree._flush_watchers,
                      tree.jobs._queue, tree])
    graveyard.extend(killed)

    be.crash_volatile()
    db._crashed = True
    return killed
