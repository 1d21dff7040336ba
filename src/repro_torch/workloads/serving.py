"""Open-loop LLM KV-cache serving scenarios on the DES clock.

The serving analogue of ``run_open_loop``: sequences (requests) arrive by
an ``ArrivalProcess``, each with a sampled prompt and output length, and a
single continuous-batching engine prefills/decodes them against the
two-tier paged KV stack (``repro_torch.serving``) under a selectable placement
policy — ``static`` (HBM-only with rejection), ``lru`` (hint-blind
demotion) or ``hhzs`` (the paper's §3.3–3.5 hint-driven manager).  See
``repro_torch.serving.policies``.

Engine time is charged from a deterministic cost model
(:class:`ServingCosts`): prefill per prompt token, a per-step floor, an
attention read per resident token priced by tier (host-resident KV is the
slow path; the §3.5 prefix cache serves its span at HBM price), and
migration bytes at DMA bandwidth.  Everything — arrivals, lengths,
preempt/resume churn — is seeded, so a cell's rows are byte-identical for
any worker count or telemetry setting, which is what lets serving cells
ride the existing parallel sweep driver (``repro_torch.workloads.sweep``) and
its CI determinism gates.

Preempt/resume churn: each decoded token may pause its sequence (seeded
per-sequence draws, identical across policies), modelling user think time
/ scheduler preemption.  Paused sequences go cold; the tier managers
demote them and pay promotion on resume — the churn that differentiates
placement policies (cf. Keigo's concurrency argument).

Tenants are ``TenantSpec``s whose ``workload`` is a
:class:`ServingWorkload` and whose ``slo_p99`` is a time-to-first-token
target; admission verdicts and the SLO feedback plane
(``repro_torch.obs.control``) come from the same control stack the storage
runners use.

Verification mode (``materialize=True, verify=True``): KV payloads are a
deterministic function of (sequence id, position) and every decode step
re-reads the full resident KV of every active sequence — any tier
migration or cache admit that corrupts, drops or aliases a page fails
loudly.  This is the differential the correctness suite runs under every
policy.

CLI (the serving grid; same sweep semantics as
``repro_torch.workloads.sweep``)::

  PYTHONPATH=src python -m repro_torch.workloads.serving \\
      --policies static,lru,hhzs --arrivals poisson,bursty \\
      --hbm 10,16 --rate 3 --out results/storage/serving.json
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.middleware import (DELAY, REJECT, AdmissionConfig,
                               AdmissionController)
from ..serving.paged_kv import PagedPool
from ..serving.policies import POLICIES, make_manager
from ..zoned.sim import Sim
from .runner import (ArrivalProcess, BurstyArrivals, FlashCrowdArrivals,
                     PoissonArrivals, TenantSpec)
from .ycsb import _pct


# ======================================================================
# specs
# ======================================================================
@dataclass(frozen=True)
class ServingWorkload:
    """Prompt/output shape of one serving tenant's traffic.

    Lengths are lognormal around the medians (the shape observed in chat
    traces), clipped to the caps.  ``pause_prob`` is the per-decoded-token
    probability the sequence pauses (user think time / preemption) for an
    Exp(``pause_mean``) interval.  ``slo_ttft`` is the tenant's
    time-to-first-token p99 target in virtual seconds (the serving
    ``TenantSpec.slo_p99``)."""

    name: str = "chat"
    prompt_med: int = 96
    prompt_sigma: float = 0.6
    prompt_max: int = 384
    out_med: int = 48
    out_sigma: float = 0.5
    out_max: int = 192
    pause_prob: float = 0.005
    pause_mean: float = 8.0
    slo_ttft: Optional[float] = None

    def _lengths(self, rng: np.random.Generator, n: int, med: int,
                 sigma: float, cap: int) -> np.ndarray:
        ln = rng.lognormal(np.log(max(med, 1)), sigma, n)
        return np.clip(np.rint(ln), 1, cap).astype(np.int64)

    def sample(self, rng: np.random.Generator,
               n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(prompt_lens, out_lens) for n requests — one vectorized draw
        per run so the streams are policy-independent."""
        return (self._lengths(rng, n, self.prompt_med, self.prompt_sigma,
                              self.prompt_max),
                self._lengths(rng, n, self.out_med, self.out_sigma,
                              self.out_max))


@dataclass(frozen=True)
class ServingPool:
    """Sizing of the two-tier paged KV stack for one cell."""

    hbm_zones: int = 12
    host_zones: int = 96
    pages_per_zone: int = 4
    page_size: int = 16
    num_layers: int = 2
    kv_heads: int = 2
    head_dim: int = 16
    cache_zones: int = 2               # §3.5 reserved prefix-cache zones
    max_batch: int = 8                 # live (running+paused) sequences
    migration_budget: int = 1          # zones per tick (§3.4 rate limit)

    @property
    def zone_tokens(self) -> int:
        return self.pages_per_zone * self.page_size

    def build(self, materialize: bool = False, torch_device: str = "cuda"
              ) -> Tuple[PagedPool, PagedPool]:
        """(device tier, host tier); a materialized device tier keeps its
        pages on ``torch_device``."""
        mk = lambda name, zones, host: PagedPool(
            name, self.num_layers, zones, self.pages_per_zone,
            self.page_size, self.kv_heads, self.head_dim, host=host,
            materialize=materialize, torch_device=torch_device)
        return (mk("hbm", self.hbm_zones, False),
                mk("host", self.host_zones, True))


@dataclass(frozen=True)
class ServingCosts:
    """Virtual-seconds cost model of one engine step (all deterministic).

    ``decode_base`` is the per-step floor (kernel launch + sampling);
    each active sequence adds its resident-KV read priced per token by
    tier; prompt prefill charges per token; migration bytes issued this
    step are charged at ``dma_bandwidth``."""

    prefill_token: float = 1e-4
    decode_base: float = 2e-3
    hbm_token: float = 1e-6
    host_token: float = 2e-5
    dma_bandwidth: float = 8 * 2**20   # bytes / virtual second


# ======================================================================
# the engine run
# ======================================================================
@dataclass
class _Live:
    """One admitted sequence inside the engine."""
    ti: int
    i: int
    sid: int
    out_target: int
    rng: np.random.Generator
    state: str = "running"             # running | paused
    produced: int = 0
    resume_at: float = 0.0
    last_tok: float = 0.0
    skip_gap: bool = False             # first token after a pause: the
    # think-time is not engine latency (the promotion stall after it is)


def _payload(sid: int, pos: int, shape) -> np.ndarray:
    """Deterministic token KV payload for the verification differential."""
    return np.full(shape, ((sid * 100003 + pos) % 65521) / 7.0, np.float32)


def _verify_resident(mgr, seq, shape) -> None:
    """Re-read a sequence's full resident KV; raise if any page was
    corrupted, dropped or aliased by migration."""
    pos = 0
    pool = mgr.pool_of(seq)
    for z in seq.zones:
        for idx in range(z.write_ptr):
            k, _ = pool.read_token(z, idx)
            want = _payload(seq.sid, pos, shape)
            if not np.array_equal(k, want):
                raise AssertionError(
                    f"KV mismatch: sid={seq.sid} pos={pos} tier={seq.tier} "
                    f"zone={z.zid} got {k.flat[0]} want {want.flat[0]}")
            pos += 1


def _verify_cache(mgr, sid: int, shape) -> None:
    """The cached prefix copy must read back as the sequence's first
    tokens — the §3.5 consistency invariant after demotion."""
    cz = mgr.prefix_cache.get(sid)
    if cz is None:
        return
    for idx in range(cz.write_ptr):
        k, _ = mgr.hbm.read_token(cz, idx)
        want = _payload(sid, idx, shape)
        if not np.array_equal(k, want):
            raise AssertionError(
                f"prefix-cache mismatch: sid={sid} pos={idx} "
                f"got {k.flat[0]} want {want.flat[0]}")


@dataclass
class ServingResult:
    """One serving run: per-tenant rows + run-level manager stats."""

    rows: List[Dict]
    stats: Dict[str, float]
    duration: float

    def row(self) -> str:
        r = self.rows[0]
        return (f"serving {r['tiering']:<6s} {r['workload']:<6s} "
                f"{r['arrival']:<28s} ttft_p99={r['ttft_p']['p99']:7.3f}s "
                f"decode_p99={r['decode_p']['p99'] * 1e3:7.2f}ms "
                f"hbm_hit={r['hbm_hit_rate']:.3f} "
                f"adm={r['admitted']}/{r['n_arrived']}")


def run_serving(tenants: Sequence[TenantSpec],
                policy: str = "hhzs", *,
                pool: Optional[ServingPool] = None,
                costs: Optional[ServingCosts] = None,
                duration: float = 300.0,
                warmup: float = 30.0,
                seed: int = 1,
                admission: Union[AdmissionConfig, str, None] = None,
                materialize: bool = False,
                verify: Union[bool, str] = False,
                sim: Optional[Sim] = None,
                registry=None,
                torch_device: str = "cuda") -> ServingResult:
    """Open-loop serving run: arrivals -> admission -> prefill -> decode.

    Each ``TenantSpec``'s workload must be a :class:`ServingWorkload`;
    its ``slo_p99`` is a TTFT target.  Deterministic given (tenants,
    policy, pool, costs, duration, seed) — telemetry (``registry``) is
    pull-only and never changes the rows.

    ``verify=True`` (needs ``materialize=True``) re-reads every
    sequence's full KV at completion and its cached prefix every decode
    step; ``verify="step"`` re-reads the full resident KV of every
    active sequence every step — O(steps x batch x length), for
    test-scale runs only.  A materialized run keeps its device tier's
    pages on ``torch_device`` (the CUDA card unless the caller passes
    ``"cpu"``); a CUDA device that is missing raises, materialized or
    not."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} (known {POLICIES})")
    if (torch.device(torch_device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(f"torch_device={torch_device!r} but CUDA is not "
                           "available; pass torch_device='cpu'")
    pool = pool or ServingPool()
    costs = costs or ServingCosts()
    if verify and not materialize:
        raise ValueError("verify=True needs materialize=True")
    sim = sim or Sim()
    hbm, host = pool.build(materialize=materialize,
                           torch_device=torch_device)
    mgr = make_manager(policy, hbm, host, cache_zones=pool.cache_zones,
                       migration_zone_budget_per_step=pool.migration_budget)
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    wls: List[ServingWorkload] = []
    for t in tenants:
        if not isinstance(t.workload, ServingWorkload):
            raise TypeError(f"tenant {t.name!r}: serving tenants take a "
                            f"ServingWorkload, got {type(t.workload)}")
        wls.append(t.workload)
    kv_shape = (pool.num_layers, pool.kv_heads, pool.head_dim)

    ctrl = AdmissionController(
        sim, None, admission if admission is not None else "none")
    prot = frozenset(t.name for t in tenants if t.protected)
    if prot:
        ctrl.cfg = replace(ctrl.cfg,
                           protected=frozenset(ctrl.cfg.protected) | prot)
    control = None
    if ctrl.cfg.policy == "feedback":
        from ..obs.control import ControlPlane
        control = ControlPlane(
            sim, ctrl,
            targets={t.name: t.slo_p99 for t in tenants
                     if t.protected and t.slo_p99},
            registry=registry)
        control.start()

    # seeded streams, mirroring run_multi_tenant's per-tenant strides
    rels, prompts, outs = [], [], []
    for ti, t in enumerate(tenants):
        arr_rng = np.random.default_rng(seed + 2 + 9973 * ti)
        rels.append(t.arrival.times(arr_rng, duration))
        len_rng = np.random.default_rng(seed + 5 + 9973 * ti)
        p, o = wls[ti].sample(len_rng, len(rels[ti]))
        prompts.append(p)
        outs.append(o)
    m_at = np.concatenate(rels) if rels else np.empty(0, np.float64)
    m_ti = np.concatenate([np.full(len(r), ti, np.int64)
                           for ti, r in enumerate(rels)]) \
        if rels else np.empty(0, np.int64)
    m_i = np.concatenate([np.arange(len(r), dtype=np.int64)
                          for r in rels]) if rels else np.empty(0, np.int64)
    order = np.argsort(m_at, kind="stable")
    m_at, m_ti, m_i = m_at[order], m_ti[order], m_i[order]
    # sid = merged arrival rank: deterministic and policy-independent
    sids = [np.full(len(r), -1, np.int64) for r in rels]
    for j in range(len(m_at)):
        sids[int(m_ti[j])][int(m_i[j])] = j

    t0 = sim.now
    arrive = [np.full(len(r), np.nan) for r in rels]
    first = [np.full(len(r), np.nan) for r in rels]       # TTFT stamp
    done = [np.full(len(r), np.nan) for r in rels]
    shed = [np.zeros(len(r), bool) for r in rels]
    cap_rej = [0] * len(tenants)          # policy capacity rejections
    tok_hbm = [0] * len(tenants)          # resident-KV reads by tier
    tok_host = [0] * len(tenants)
    tok_out = [0] * len(tenants)
    gaps: List[List[float]] = [[] for _ in tenants]        # decode gaps
    pauses = [0] * len(tenants)
    queue: List[Tuple[int, int]] = []
    live: Dict[int, _Live] = {}
    idle: List = []
    state = {"dispatched": False, "holding": 0, "max_queue": 0,
             "max_live": 0}
    eng = {"steps": 0, "tokens_out": 0}   # registry-visible counters
    ctrl.queue_gauge = lambda: len(queue)

    def _enqueue(ti: int, i: int) -> None:
        queue.append((ti, i))
        state["max_queue"] = max(state["max_queue"], len(queue))
        if idle:
            idle.pop().succeed()

    def _maybe_close() -> None:
        if state["dispatched"] and state["holding"] == 0:
            while idle:
                idle.pop().succeed()

    def held(ti: int, i: int):
        yield from ctrl.hold(names[ti])
        state["holding"] -= 1
        _enqueue(ti, i)
        _maybe_close()

    def dispatcher():
        for j in range(len(m_at)):
            at = t0 + float(m_at[j])
            if at > sim.now:
                yield at - sim.now
            ti, i = int(m_ti[j]), int(m_i[j])
            arrive[ti][i] = sim.now
            verdict = ctrl.decide(names[ti])
            if verdict == REJECT:
                shed[ti][i] = True
                continue
            if verdict == DELAY:
                state["holding"] += 1
                sim.process(held(ti, i))
                continue
            _enqueue(ti, i)
        state["dispatched"] = True
        _maybe_close()

    def _write_tok(seq, sid: int) -> None:
        zone = mgr.writable_zone(seq)
        if materialize:
            pl = _payload(sid, seq.length, kv_shape)
            mgr.pool_of(seq).write_token(zone, pl, pl)
        else:
            mgr.pool_of(seq).write_token(zone)
        seq.length += 1

    def engine():
        while True:
            if not queue and not live:
                if state["dispatched"] and state["holding"] == 0:
                    return
                ev = sim.event()
                idle.append(ev)
                yield ev
                continue
            now = sim.now
            for r in live.values():
                if r.state == "paused" and r.resume_at <= now:
                    r.state = "running"
            running = [r for r in live.values() if r.state == "running"]
            if not running and not (queue and len(live) < pool.max_batch):
                # everyone is paused and no admission is possible: sleep
                # to the earliest resume (arrivals in between just queue)
                nxt = min(r.resume_at for r in live.values()
                          if r.state == "paused")
                yield max(nxt - now, 1e-9)
                continue
            cost = costs.decode_base
            admitted_now: List[_Live] = []
            while queue and len(live) < pool.max_batch:
                ti, i = queue.pop(0)
                sid = int(sids[ti][i])
                total = int(prompts[ti][i] + outs[ti][i])
                if not mgr.admit(sid, total):
                    shed[ti][i] = True
                    cap_rej[ti] += 1
                    continue
                seq = mgr.on_prefill(sid, int(prompts[ti][i]))
                for _ in range(int(prompts[ti][i])):
                    _write_tok(seq, sid)
                cost += int(prompts[ti][i]) * costs.prefill_token
                r = _Live(ti=ti, i=i, sid=sid,
                          out_target=int(outs[ti][i]),
                          rng=np.random.default_rng(
                              (seed + 11) * 1_000_003 + sid))
                live[sid] = r
                admitted_now.append(r)
                state["max_live"] = max(state["max_live"], len(live))
            running = [r for r in live.values() if r.state == "running"]
            mig0 = mgr.stats["bytes_migrated"]
            mgr.tick([r.sid for r in running])
            for r in running:
                seq = mgr.seqs[r.sid]
                h, c = mgr.residency(seq)
                tok_hbm[r.ti] += h
                tok_host[r.ti] += c
                cost += h * costs.hbm_token + c * costs.host_token
                if verify == "step":
                    _verify_resident(mgr, seq, kv_shape)
                if verify:
                    _verify_cache(mgr, r.sid, kv_shape)
                _write_tok(seq, r.sid)
                r.produced += 1
            cost += (mgr.stats["bytes_migrated"] - mig0) \
                / costs.dma_bandwidth
            eng["steps"] += 1
            yield cost
            now = sim.now
            for r in admitted_now:
                first[r.ti][r.i] = now
            for r in running:
                tok_out[r.ti] += 1
                eng["tokens_out"] += 1
                if r.produced > 1 and not r.skip_gap:
                    gaps[r.ti].append(now - r.last_tok)
                r.skip_gap = False
                r.last_tok = now
                if r.produced >= r.out_target:
                    done[r.ti][r.i] = now
                    if verify:
                        _verify_resident(mgr, mgr.seqs[r.sid], kv_shape)
                    mgr.release(r.sid)
                    del live[r.sid]
                    if control is not None:
                        control.observe(names[r.ti],
                                        now - arrive[r.ti][r.i])
                elif r.rng.random() < wls[r.ti].pause_prob:
                    r.state = "paused"
                    r.skip_gap = True
                    r.resume_at = now + r.rng.exponential(
                        wls[r.ti].pause_mean)
                    pauses[r.ti] += 1

    if registry is not None:
        registry.gauge("serving.hbm_free_zones",
                       lambda: float(hbm.num_free()))
        registry.gauge("serving.host_free_zones",
                       lambda: float(host.num_free()))
        registry.gauge("serving.queue_depth", lambda: float(len(queue)))
        registry.gauge("serving.live_seqs", lambda: float(len(live)))
        registry.attach_dict(mgr.stats, prefix="serving.", rate=True,
                             name="serving.mgr")
        registry.attach_dict(eng, prefix="serving.", rate=True,
                             name="serving.engine")
        registry.start()

    sim.process(dispatcher())
    eng_proc = sim.process(engine())
    sim.run_until(eng_proc)
    busy = max(sim.now - t0, 1e-12)
    ctrl.queue_gauge = None
    if control is not None:
        control.stop()

    rows: List[Dict] = []
    for ti, t in enumerate(tenants):
        arr, fs, dn = arrive[ti], first[ti], done[ti]
        completed = ~np.isnan(dn)
        measured = completed & (arr - t0 >= warmup)
        ttft = (fs - arr)[measured & ~np.isnan(fs)]
        n_arrived = len(arr)
        admitted = int(n_arrived - shed[ti].sum())
        reads = tok_hbm[ti] + tok_host[ti]
        row = {
            "workload": wls[ti].name,
            "arrival": t.arrival.name,
            "tiering": policy,
            "serving_tenant": t.name,
            "admission_policy": ctrl.cfg.label or ctrl.cfg.policy,
            "admission": dict(ctrl.tenant_counters(names[ti])),
            "n_arrived": n_arrived,
            "admitted": admitted,
            "rejected": int(shed[ti].sum()),
            "capacity_rejected": cap_rej[ti],
            "n_completed": int(completed.sum()),
            "n_measured": int(measured.sum()),
            "duration": float(duration),
            "offered_rate": n_arrived / max(duration, 1e-12),
            "throughput": float(completed.sum()) / busy,
            "token_throughput": tok_out[ti] / busy,
            "tokens_out": tok_out[ti],
            "ttft_p": _pct(ttft),
            "decode_p": _pct(np.asarray(gaps[ti])),
            "mean_ttft": float(ttft.mean()) if len(ttft) else 0.0,
            "hbm_hit_rate": (tok_hbm[ti] / reads) if reads else 1.0,
            "cache_hits": int(mgr.stats["cache_hits"]),
            "cache_admits": int(mgr.stats["cache_admits"]),
            "promote_pages": int(mgr.stats["promote_pages"]),
            "demote_pages": int(mgr.stats["demote_pages"]),
            "migrated_bytes": float(mgr.stats["bytes_migrated"]),
            "preempt_stalls": int(mgr.stats["preempt_stalls"]),
            "pauses": pauses[ti],
            "hbm_placements": int(mgr.stats["hbm_placements"]),
            "host_placements": int(mgr.stats["host_placements"]),
            "hbm_zones": pool.hbm_zones,
            "host_zones": pool.host_zones,
            "max_batch": pool.max_batch,
            "max_live": state["max_live"],
            "queue_depth_max": state["max_queue"],
        }
        if t.slo_p99:
            row["slo_p99"] = float(t.slo_p99)
            row["slo_met"] = bool(row["ttft_p"]["p99"] <= t.slo_p99)
            ok = measured & ~np.isnan(fs) & (fs - arr <= t.slo_p99)
            row["goodput"] = float(ok.sum()) / busy
        rows.append(row)
    stats = dict(mgr.stats)
    stats.update(steps=eng["steps"], tokens_out=eng["tokens_out"],
                 hbm_free_zones=hbm.num_free(),
                 host_free_zones=host.num_free())
    return ServingResult(rows=rows, stats=stats, duration=busy)


# ======================================================================
# matrix integration
# ======================================================================
@dataclass(frozen=True)
class ServingCell:
    """One serving cell of a ``ScenarioMatrix``: policy x workload x
    arrival x pool sizing — self-contained, like ``ScenarioCell``."""

    policy: str
    workload: ServingWorkload
    arrival: ArrivalProcess
    spool: ServingPool

    @property
    def name(self) -> str:
        return (f"serving/{self.policy}/{self.workload.name}"
                f"/{self.arrival.name}/h{self.spool.hbm_zones}")


def run_matrix_cell(matrix, cell: ServingCell
                    ) -> Tuple[List[ServingResult], List[Dict]]:
    """Run one serving cell for ``ScenarioMatrix.run_cell`` (same
    contract: fresh state, rows tagged with the cell name)."""
    sim = Sim()
    reg = None
    if matrix.telemetry or matrix.timeline_dir is not None:
        period = (float(matrix.telemetry)
                  if not isinstance(matrix.telemetry, bool)
                  and matrix.telemetry else 5.0)
        from ..obs.metrics import MetricsRegistry
        reg = MetricsRegistry(sim, period)
    tenants = [TenantSpec(
        name="default", workload=cell.workload, arrival=cell.arrival,
        protected=cell.workload.slo_ttft is not None,
        slo_p99=cell.workload.slo_ttft)]
    res = run_serving(
        tenants, cell.policy, pool=cell.spool,
        costs=matrix.serving_costs or ServingCosts(),
        duration=matrix.duration, warmup=matrix.warmup, seed=matrix.seed,
        admission=matrix.serving_admission, sim=sim, registry=reg,
        torch_device=matrix.torch_device)
    if reg is not None:
        reg.sample_now()
        if matrix.timeline_dir is not None:
            from ..obs.metrics import timeline_path
            reg.dump_timeline(
                timeline_path(matrix.timeline_dir, cell.name),
                meta={"cell": cell.name, "policy": cell.policy,
                      "hbm_zones": cell.spool.hbm_zones})
    for row in res.rows:
        row["cell"] = cell.name
    return [res], res.rows


def serving_arrivals(kinds: Sequence[str],
                     rate: float) -> List[ArrivalProcess]:
    """Serving arrival shapes anchored to one sequence rate (seqs/s)."""
    table = {
        "poisson": PoissonArrivals(round(rate, 4)),
        "bursty": BurstyArrivals(round(0.3 * rate, 4),
                                 round(2.5 * rate, 4), on=30.0, off=90.0),
        "flash": FlashCrowdArrivals(round(0.6 * rate, 4),
                                    round(4.0 * rate, 4),
                                    at=60.0, decay=30.0),
    }
    unknown = [k for k in kinds if k not in table]
    if unknown:
        raise ValueError(f"unknown arrival kinds {unknown}; "
                         f"one of {sorted(table)}")
    return [table[k] for k in kinds]


def build_serving_grid(policies: Sequence[str],
                       arrival_kinds: Sequence[str],
                       hbm_zones: Sequence[int], *,
                       rate: float = 2.5,
                       duration: float = 400.0,
                       warmup: float = 40.0,
                       seed: int = 1,
                       workload: Optional[ServingWorkload] = None,
                       admission: Union[AdmissionConfig, str, None] = None,
                       telemetry: Union[bool, float] = False,
                       timeline_dir=None,
                       torch_device: str = "cuda"):
    """A serving-only ``ScenarioMatrix``: policy x arrival x HBM sizing."""
    from .runner import ScenarioMatrix
    wl = workload or ServingWorkload(slo_ttft=2.0)
    return ScenarioMatrix(
        schemes=(), workloads=(),
        arrivals=serving_arrivals(arrival_kinds, rate),
        duration=duration, warmup=warmup, seed=seed,
        serving_policies=tuple(policies),
        serving_workloads=(wl,),
        serving_pools=tuple(ServingPool(hbm_zones=h) for h in hbm_zones),
        serving_admission=admission,
        telemetry=telemetry, timeline_dir=timeline_dir,
        torch_device=torch_device)


# ======================================================================
# CLI
# ======================================================================
def main(argv: Optional[Sequence[str]] = None) -> int:
    from .sweep import run_sweep
    ap = argparse.ArgumentParser(
        description="LLM KV-cache serving grid (policy x arrival x pool)")
    ap.add_argument("--policies", default="static,lru,hhzs")
    ap.add_argument("--arrivals", default="poisson,bursty")
    ap.add_argument("--hbm", default="10,16",
                    help="comma list of HBM zone counts")
    ap.add_argument("--rate", type=float, default=2.5,
                    help="sequence arrival rate anchor (seqs/s)")
    ap.add_argument("--duration", type=float, default=400.0)
    ap.add_argument("--warmup", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--timelines", default=None,
                    help="directory for per-cell timeline artifacts")
    ap.add_argument("--fresh", action="store_true",
                    help="re-run cells already present in --out")
    ap.add_argument("--quick", action="store_true",
                    help="tiny sizing for CI smoke")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the device tier is checked for "
                         "('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    if args.quick:
        args.duration, args.warmup = 150.0, 20.0
    matrix = build_serving_grid(
        [p for p in args.policies.split(",") if p],
        [a for a in args.arrivals.split(",") if a],
        [int(h) for h in args.hbm.split(",") if h],
        rate=args.rate, duration=args.duration, warmup=args.warmup,
        seed=args.seed,
        telemetry=args.timelines is not None,
        timeline_dir=args.timelines, torch_device=args.torch_device)
    rows = run_sweep(matrix, args.out, workers=args.workers,
                     resume=not args.fresh)
    if args.out is None:
        print(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    import sys

    # delegate to the canonical module object (already imported via the
    # package), not this __main__ copy: cells built here would pickle as
    # __main__.* and fail isinstance checks in sweep worker processes
    from repro_torch.workloads.serving import main as _main
    sys.exit(_main())
