"""The port's telemetry, control plane, multi-tenant runner, scenario
matrix, sweeps, drift and serving grid held against the JAX package.

Every test drives ``repro`` and ``repro_torch`` (stores at
``torch_device="cpu"``, asked for explicitly: here there is no card) with
the same seeded inputs on ``tiny_scenario()`` stores, and compares what
comes out exactly: result rows as JSON bytes, control traces, rate
overrides and manager stats are integers and floats computed by the same
simulator history.  The port's own contracts are held beside: rows with
telemetry on equal rows with it off, rows are the same at any sweep
worker count (the port's workers are spawned), drift's per-phase counts
conserve, and ``verify="step"`` re-reads every resident KV page.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny_scenario  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro import workloads as ref_wl  # noqa: E402
from repro.core import middleware as ref_mw  # noqa: E402
from repro.lsm import DB as RefDB  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.workloads import serving as ref_serving  # noqa: E402
from repro.workloads import sweep as ref_sweep  # noqa: E402
from repro.zoned import faults as ref_faults  # noqa: E402
from repro.zoned import sim as ref_sim  # noqa: E402
import repro_torch.lsm as pt_lsm  # noqa: E402
from repro_torch import obs as pt_obs  # noqa: E402
from repro_torch import workloads as pt_wl  # noqa: E402
from repro_torch.core import middleware as pt_mw  # noqa: E402
from repro_torch.obs import metrics as pt_metrics  # noqa: E402
from repro_torch.workloads import serving as pt_serving  # noqa: E402
from repro_torch.workloads import sweep as pt_sweep  # noqa: E402
from repro_torch.zoned import faults as pt_faults  # noqa: E402
from repro_torch.zoned import sim as pt_sim  # noqa: E402
from test_torch_store import port_scenario  # noqa: E402

REF = SimpleNamespace(
    name="ref", wl=ref_wl, obs=ref_obs, mw=ref_mw, metrics=ref_metrics,
    serving=ref_serving, sweep=ref_sweep, faults=ref_faults, sim=ref_sim,
    db=lambda scheme, sc, **kw: RefDB(scheme, sc, **kw),
    factory=lambda **kw: ref_sweep.GridDBFactory(**kw), device={})
PORT = SimpleNamespace(
    name="port", wl=pt_wl, obs=pt_obs, mw=pt_mw, metrics=pt_metrics,
    serving=pt_serving, sweep=pt_sweep, faults=pt_faults, sim=pt_sim,
    db=lambda scheme, sc, **kw: pt_lsm.DB(scheme, port_scenario(sc),
                                          torch_device="cpu", **kw),
    factory=lambda **kw: pt_sweep.GridDBFactory(torch_device="cpu", **kw),
    device={"torch_device": "cpu"})
PKGS = (REF, PORT)


def _dump(rows) -> str:
    return json.dumps(rows, sort_keys=True)


def _both(drive):
    """``drive(pkg)`` on each package; the port's result, after checking
    it equals the reference's byte for byte."""
    ref, port = (_dump(drive(pkg)) for pkg in PKGS)
    assert port == ref
    return json.loads(port)


def _loaded(pkg, scheme="HHZS", n=1200, ssd_zones=20, **db_kw):
    db = pkg.db(scheme, tiny_scenario(ssd_zones=ssd_zones),
                store_values=True, **db_kw)
    pkg.wl.run_load(db, n_keys=n)
    db.flush_all()
    db.n_keys = n
    return db


def _factory(pkg, n: int = 800):
    """A (scheme, ssd_zones) -> loaded tiny store factory for one
    package."""
    return lambda scheme, ssd_zones: _loaded(pkg, scheme, n, ssd_zones)


MIX = ("mix", dict(read=0.5, update=0.5, alpha=0.9))
READMIX = ("readmix", dict(read=0.9, update=0.1, alpha=0.99))


def _spec(pkg, spec):
    return pkg.wl.WorkloadSpec(spec[0], **spec[1])


# ----------------------------------------------------------------------
# telemetry: rows with the bus on equal rows with it off
# ----------------------------------------------------------------------
def _telemetry_rows(pkg, kind, telemetry, tmp_path):
    wl = pkg.wl
    if kind == "open_loop":
        db = _loaded(pkg, telemetry=telemetry)
        return [wl.run_open_loop(db, wl.YCSB["A"], wl.PoissonArrivals(10.0),
                                 duration=90.0, n_keys=db.n_keys,
                                 warmup=10.0, max_concurrency=8, seed=9,
                                 read_batch=8).to_json()]
    if kind == "multi_tenant":
        db = _loaded(pkg, "B3", telemetry=telemetry)
        mix = [wl.TenantSpec("a", wl.YCSB["A"], wl.PoissonArrivals(4.0),
                             protected=True),
               wl.TenantSpec("b", wl.YCSB["C"], wl.PoissonArrivals(6.0))]
        res = wl.run_multi_tenant(
            db, mix, duration=90.0, n_keys=db.n_keys, warmup=10.0,
            max_concurrency=8,
            policy=pkg.mw.AdmissionConfig(policy="reject",
                                          queue_threshold=16))
        return res.rows()
    # a scenario matrix, its cells' timelines written beside
    tl = tmp_path / f"{pkg.name}-{telemetry}"
    matrix = wl.ScenarioMatrix(
        schemes=["B3"], workloads=[_spec(pkg, MIX)],
        arrivals=[wl.PoissonArrivals(6.0)], ssd_zone_budgets=[20],
        duration=60.0, warmup=5.0, max_concurrency=8,
        db_factory=_factory(pkg),
        telemetry=2.0 if telemetry else False,
        timeline_dir=tl if telemetry else None, **pkg.device)
    rows = matrix.run(verbose=False)
    if telemetry:
        (f,) = tl.glob("*.json")
        rows.append(json.loads(f.read_text()))
    return rows


@pytest.mark.parametrize("kind", ["open_loop", "multi_tenant", "matrix"])
def test_telemetry_on_rows_equal_off_rows_and_reference(kind, tmp_path):
    """Rows with the bus on are the rows with it off, in both packages
    and between them; the matrix's timeline artifact is the reference's
    too, series for series."""
    on = _both(lambda pkg: _telemetry_rows(pkg, kind, 1.0, tmp_path))
    off = _both(lambda pkg: _telemetry_rows(pkg, kind, False, tmp_path))
    if kind == "matrix":
        timeline = on.pop()
        assert timeline["meta"]["cell"] == "B3/mix/poisson(6)/z20"
        assert len(timeline["t"]) >= 10 and "lsm.debt" in timeline["series"]
    assert on == off


def test_telemetry_survives_crash_reopen():
    """The sampler resumes after a crash and reopen; the gauges rebind to
    the recovered tree: the series as the reference's."""
    def drive(pkg):
        db = _loaded(pkg, telemetry=1.0)
        db.run_for(5.0)
        db.crash()
        db.reopen()
        db.run_for(10.0)
        for k in range(400):
            db.put(k + 10_000_000)
        db.flush_all()
        db.run_for(2.0)
        db.metrics.sample_now()
        return db.metrics.timeline()
    tl = _both(drive)
    assert any(v for v in tl["series"]["lsm.flush_rate"][-5:])


# ----------------------------------------------------------------------
# the control plane
# ----------------------------------------------------------------------
def _aimd_trace(pkg):
    sim = pkg.sim.Sim()
    cfg = pkg.mw.AdmissionConfig(
        policy="feedback", protected=frozenset(["a"]),
        bucket_rates={"b": (100.0, 5.0)}, feedback_decrease=0.5,
        feedback_increase=0.1, feedback_headroom=0.8, feedback_floor=0.05)
    ctrl = pkg.mw.AdmissionController(sim, None, cfg)
    ctrl.tenant_counters("a")
    ctrl.tenant_counters("b")
    plane = pkg.obs.ControlPlane(sim, ctrl, targets={"a": 0.1})
    trace = []
    for _ in range(16):
        plane.observe("a", 1.0)
    for _ in range(22):
        plane._tick()
        trace.append(ctrl.rate_overrides["b"])
    plane._lat["a"].clear()
    for _ in range(16):
        plane.observe("a", 0.01)
    for _ in range(5):
        plane._tick()
        trace.append(ctrl.rate_overrides["b"])
    return {"trace": trace, "protected": "a" in ctrl.rate_overrides,
            "attainment": plane.attainment()}


def _pi_steps(pkg):
    pi = pkg.obs.PIController(kp=0.6, ki=0.15, setpoint=1.0, lo=0.05,
                              hi=1.0)
    us = [pi.update(m, 1.0) for m in [1.0] + [1.5] * 220 + [0.5] * 60]
    f = pkg.obs.Ewma(alpha=0.5)
    return {"u": us, "integral": pi.integral,
            "ewma": [f.update(v) for v in (2.0, 0.0, 0.0, 3.0)]}


def _square_wave(pkg):
    out = {}
    for law in ("aimd", "pi"):
        sim = pkg.sim.Sim()
        cfg = pkg.mw.AdmissionConfig(
            policy="feedback", protected=frozenset(["a"]),
            bucket_rates={"b": (100.0, 5.0)}, feedback_controller=law,
            feedback_interval=1.0, feedback_decrease=0.5,
            feedback_increase=0.1, feedback_headroom=0.8,
            feedback_floor=0.05, feedback_kp=0.6, feedback_ki=0.15,
            feedback_smooth=0.5)
        ctrl = pkg.mw.AdmissionController(sim, None, cfg)
        ctrl.tenant_counters("a")
        ctrl.tenant_counters("b")
        plane = pkg.obs.ControlPlane(sim, ctrl, targets={"a": 0.1})
        us = []
        for worst in ([1.5] * 30 + [0.6] * 30) * 2:
            if law == "pi":
                plane._tick_pi(worst)
            else:
                plane._tick_aimd(worst, worst > 1.0)
            us.append(plane._u)
        out[law] = {"u": us, "overrides": dict(ctrl.rate_overrides)}
    return out


def _debt_share(pkg):
    """Tagged writes 3:1 between two tenants on a live store: the debt
    attribution (conserved against ``compaction_debt``) mid-flight, and
    the PI law's rate overrides biased by each tenant's share."""
    db = pkg.db("B3", tiny_scenario(), store_values=True)

    def writer(tenant, lo, n):
        for k in range(lo, lo + n):
            yield from db.tree.put(k, tenant=tenant)
    procs = [db.sim.process(writer("x", 0, 4500)),
             db.sim.process(writer("y", 4500, 1500))]
    for p in procs:
        db.sim.run_until(p)
    by = db.tree.debt_by_tenant()
    cfg = pkg.mw.AdmissionConfig(
        policy="feedback", protected=frozenset(["a"]),
        bucket_rates={"x": (100.0, 5.0), "y": (100.0, 5.0)},
        feedback_controller="pi", feedback_kp=0.6, feedback_ki=0.15,
        feedback_smooth=0.5)
    ctrl = pkg.mw.AdmissionController(db.sim, None, cfg)
    for t in ("a", "x", "y"):
        ctrl.tenant_counters(t)
    plane = pkg.obs.ControlPlane(db.sim, ctrl, targets={"a": 0.1}, db=db)
    shares = plane.debt_shares()
    for _ in range(2):
        plane._tick_pi(1.2)
    return {"by": by, "debt": float(db.tree.compaction_debt()),
            "shares": shares, "rates": dict(ctrl.rate_overrides)}


@pytest.mark.parametrize("trace", ["aimd", "pi", "square_wave",
                                   "debt_share"])
def test_control_traces_match_reference(trace):
    """The AIMD halving trace (50 then 25 of a base rate of 100, the floor,
    the additive step back), the PI controller's steps through overload,
    saturation and recovery, both laws on a square wave, and the PI
    law's throttle biased by each tenant's share of the debt."""
    got = _both({"aimd": _aimd_trace, "pi": _pi_steps,
                 "square_wave": _square_wave,
                 "debt_share": _debt_share}[trace])
    if trace == "aimd":
        assert got["trace"][:2] == [50.0, 25.0]
        assert min(got["trace"]) >= 0.05 * 100.0 - 1e-9
        assert got["trace"][-5] == pytest.approx(got["trace"][-6] + 10.0)
        assert not got["protected"] and got["attainment"] == 1.0
    elif trace == "pi":
        assert got["u"][0] == pytest.approx(1.0)
        assert got["u"][-1] == pytest.approx(1.0)
        assert min(got["u"]) == pytest.approx(0.05)
    elif trace == "square_wave":
        assert got["aimd"]["u"][29] < 0.3 and got["pi"]["u"][59] > 0.9
    else:
        assert sum(got["by"].values()) == pytest.approx(got["debt"])
        assert got["shares"]["x"] > got["shares"]["y"] > 0.0
        assert got["rates"]["x"] < got["rates"]["y"] < 100.0


def _knob_state(pkg):
    """Each knob's value at u = 1, 0 and 0.5 on a live store, and after
    ``stop()``."""
    db = _loaded(pkg, n=600)
    cfg = pkg.mw.AdmissionConfig(
        policy="feedback", protected=frozenset(["a"]),
        feedback_knobs=("admission", "compaction", "migration", "cache"))
    ctrl = db.fresh_admission(cfg)
    plane = pkg.obs.ControlPlane(db.sim, ctrl, targets={"a": 0.1},
                                 debt_gauge=ctrl.debt_gauge, db=db)
    seen = []
    for u in (1.0, 0.0, 0.5, None):
        if u is None:
            plane.stop()
        else:
            plane._apply_knobs(u)
        seen.append([db.tree.compaction_pace,
                     db.backend.migrator.rate_limit,
                     db.backend.cache_zone_budget, plane.knob_summary()])
    return seen


def test_knob_actuation_matches_reference():
    """Compaction pace, migration rate and cache budget under the knob
    mapping, and neutral again after ``stop()``, as the reference's."""
    states = _both(_knob_state)
    assert states[-1][0] == 1.0 and states[-1][2] is None
    assert states[1][2] == 0


# ----------------------------------------------------------------------
# the multi-tenant runner
# ----------------------------------------------------------------------
def _policy(pkg, name):
    mw = pkg.mw
    bucket = {"crowd": (20.0, 5.0)}
    return {
        "none": "none",
        "reject": mw.AdmissionConfig(policy="reject", queue_threshold=16),
        "delay": mw.AdmissionConfig(policy="delay", queue_threshold=16),
        "token_bucket": mw.AdmissionConfig(policy="token_bucket",
                                           bucket_rates=bucket),
        "feedback": mw.AdmissionConfig(policy="feedback",
                                       bucket_rates=bucket,
                                       queue_threshold=8,
                                       feedback_interval=2.5),
        "pi+knobs": mw.AdmissionConfig(
            policy="feedback", bucket_rates=bucket, debt_threshold=1e5,
            label="pi+knobs", queue_threshold=8, feedback_interval=2.5,
            feedback_window=60, feedback_controller="pi", feedback_kp=2.0,
            feedback_ki=0.5, feedback_smooth=1.0, feedback_rise=0.08,
            feedback_knobs=("admission", "compaction", "migration",
                            "cache")),
    }[name]


def _two_tenants(pkg, steady_rate=3.0, peak=60.0):
    wl = pkg.wl
    return [wl.TenantSpec("steady", wl.YCSB["A"],
                          wl.PoissonArrivals(steady_rate), protected=True,
                          slo_p99=0.05),
            wl.TenantSpec("crowd", wl.YCSB["A"],
                          wl.FlashCrowdArrivals(1.0, peak, at=60.0,
                                                decay=60.0),
                          slo_p99=0.1)]


@pytest.mark.parametrize("policy", ["none", "reject", "delay",
                                    "token_bucket", "feedback", "pi+knobs",
                                    "crash"])
def test_run_multi_tenant_rows_match_reference(policy):
    """Two tenants on one store under each admission policy, and under a
    mid-run crash and recovery: every tenant row as the reference's, the
    admission counters conserved."""
    def drive(pkg):
        db = _loaded(pkg, "B3" if policy == "none" else "HHZS")
        faults = None
        if policy == "crash":
            faults = pkg.faults.FaultSpec(name="crash", crash_at=80.0,
                                          recovery_slo_s=10.0)
        res = pkg.wl.run_multi_tenant(
            db, _two_tenants(pkg), duration=150.0, n_keys=db.n_keys,
            warmup=10.0, max_concurrency=8,
            policy=_policy(pkg, "reject" if policy == "crash" else policy),
            faults=faults)
        return {"rows": res.rows(), "n": [res.n_arrived, res.n_completed,
                                          res.max_queue_depth],
                "extras": res.extras}
    got = _both(drive)
    for r in got["rows"]:
        a = r["admission"]
        assert a["arrived"] == a["admitted"] + a["rejected"] + a["holding"]
    assert got["n"][0] == sum(r["n_arrived"] for r in got["rows"])


def test_single_tenant_none_reproduces_open_loop():
    """Policy ``none`` with one tenant is event for event the single-stream
    runner, in the port as in the reference."""
    def drive(pkg):
        wl = pkg.wl
        ol = wl.run_open_loop(_loaded(pkg), wl.YCSB["A"],
                              wl.PoissonArrivals(10.0), duration=60.0,
                              n_keys=1200, warmup=10.0, seed=9).to_json()
        mt = wl.run_multi_tenant(
            _loaded(pkg), [wl.TenantSpec("only", wl.YCSB["A"],
                                         wl.PoissonArrivals(10.0))],
            duration=60.0, n_keys=1200, warmup=10.0, seed=9).rows()[0]
        return ol, mt
    ol, mt = _both(drive)
    for key in ("n_arrived", "n_measured", "latency_p", "queue_p",
                "service_p", "op_counts", "throughput"):
        assert mt[key] == ol[key], key


# ----------------------------------------------------------------------
# the scenario matrix and the sweep driver
# ----------------------------------------------------------------------
def _grid(pkg, **kw):
    return pkg.wl.ScenarioMatrix(
        schemes=["B3", "HHZS"], workloads=["A", "C"],
        arrivals=[pkg.wl.PoissonArrivals(50.0)], ssd_zone_budgets=[20],
        duration=20.0, warmup=5.0, key_div=512, seed=7, read_batch=16,
        db_factory=pkg.factory(key_div=512, load_div=4), **pkg.device,
        **kw)


def test_sweep_rows_match_reference_at_any_worker_count(tmp_path):
    """The port's sweep at 0 and 2 workers (spawned) writes the reference's
    rows and file, byte for byte, in canonical cell order."""
    ref = ref_sweep.run_sweep(_grid(REF), out=tmp_path / "ref.json",
                              workers=0, verbose=False)
    for workers in (0, 2):
        out = tmp_path / f"w{workers}.json"
        rows = pt_sweep.run_sweep(_grid(PORT), out=out, workers=workers,
                                  verbose=False)
        assert _dump(rows) == _dump(ref)
        assert out.read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert [r["cell"] for r in ref] == [c.name for c in _grid(PORT).cells()]


def test_sweep_resume_and_selection_as_reference(tmp_path):
    """Resume keeps completed cells (a tampered value survives), a cell
    selector runs only its cells, and foreign rows are kept, as in the
    reference's sweep."""
    def drive(pkg):
        out = tmp_path / f"{pkg.name}.json"
        out.write_text(json.dumps([{"cell": "X/other", "marker": 1}]))
        pkg.sweep.run_sweep(_grid(pkg), out=out, workers=0, verbose=False,
                            cells="HHZS/*")
        rows = json.loads(out.read_text())
        rows[1]["throughput"] = 123456.0
        out.write_text(json.dumps(rows, indent=1))
        return pkg.sweep.run_sweep(_grid(pkg), out=out, workers=0,
                                   verbose=False), json.loads(out.read_text())
    rows, on_disk = _both(drive)
    assert on_disk[0] == {"cell": "X/other", "marker": 1}
    assert len(rows) == 4 and 123456.0 in [r["throughput"] for r in rows]


def test_multi_tenant_matrix_with_faults_matches_reference(tmp_path):
    """A multi-tenant matrix across two policies and a crash cell: rows
    per tenant as the reference's, and the JSON artifact."""
    def drive(pkg):
        matrix = pkg.wl.ScenarioMatrix(
            schemes=["B3"], workloads=[], arrivals=[],
            tenants=[_two_tenants(pkg, steady_rate=2.0, peak=30.0)],
            policies=["none", _policy(pkg, "reject")],
            faults=[None, pkg.faults.FaultSpec(name="crash", crash_at=70.0)],
            ssd_zone_budgets=[20], duration=150.0, warmup=10.0,
            max_concurrency=8, db_factory=_factory(pkg), **pkg.device)
        out = tmp_path / f"{pkg.name}.json"
        return matrix.run(out=out, verbose=False), \
            json.loads(out.read_text())
    rows, on_disk = _both(drive)
    assert rows == on_disk and len(rows) == 8


def test_control_grid_matches_reference():
    """``build_control_grid``: the pi+knobs feedback cell of two tenants
    (``bench_control``'s construction at smoke sizing), telemetry on."""
    def drive(pkg):
        kw = {"torch_device": "cpu"} if pkg is PORT else {}
        matrix = pkg.sweep.build_control_grid(
            ["HHZS"], duration=60.0, warmup=10.0, key_div=256, seed=3,
            timelines=None, **kw)
        matrix.telemetry = True
        return pkg.sweep.run_sweep(matrix, out=None, workers=0,
                                   verbose=False)
    rows = _both(drive)
    assert [r["tenant"] for r in rows] == ["prot", "bulk"]


# ----------------------------------------------------------------------
# drift
# ----------------------------------------------------------------------
def _program(pkg, rate=30.0, phase_s=20.0, tenants=1):
    wl = pkg.wl
    ts = (wl.DriftTenant("t0", wl.PoissonArrivals(rate)),
          wl.DriftTenant("t1", wl.PoissonArrivals(rate / 2)))[:tenants]
    return wl.TraceProgram(
        "p2", (wl.Phase("a", phase_s, _spec(pkg, MIX)),
               wl.Phase("b", phase_s, _spec(pkg, READMIX))), ts)


@pytest.mark.parametrize("case", ["straddle", "two_tenants", "churn"])
def test_drift_rows_conserve_and_match_reference(case):
    """Per-phase counts conserve (an op straddling a boundary counts in
    the phase it arrived in; a departed tenant's queued ops drop) and
    every row is the reference's."""
    def drive(pkg):
        wl = pkg.wl
        db = _loaded(pkg, "B3", n=1000)
        if case == "straddle":
            prog, conc = _program(pkg, rate=60.0), 1
        elif case == "two_tenants":
            prog, conc = _program(pkg, rate=20.0, phase_s=10.0,
                                  tenants=2), 64
        else:
            prog = wl.TraceProgram(
                "churn-mini",
                (wl.Phase("both", 20.0, _spec(pkg, MIX),
                          tenants=("base", "batch")),
                 wl.Phase("solo", 20.0, _spec(pkg, READMIX),
                          tenants=("base",))),
                (wl.DriftTenant("base", wl.PoissonArrivals(10.0)),
                 wl.DriftTenant("batch", wl.PoissonArrivals(80.0))),
                drain_s=30.0)
            conc = 2
        return [r.to_json() for r in wl.run_drift(db, prog, n_keys=1000,
                                                  max_concurrency=conc)]
    rows = _both(drive)
    for r in rows:
        ph = r["phases"]
        assert sum(p["n_arrived"] for p in ph) == r["n_arrived"]
        assert sum(p["n_completed"] for p in ph) == r["n_completed"]
        assert r["n_arrived"] == r["n_completed"] + r["dropped"]
        for p in ph:
            assert p["n_arrived"] == p["n_completed"] + p["n_dropped"]
    if case == "straddle":
        assert rows[0]["max_queue_depth"] > 5
    if case == "churn":
        assert {r["tenant"]: r["dropped"] > 0 for r in rows} == \
            {"base": False, "batch": True}


def test_drift_matrix_rows_match_reference_telemetry_on_and_off():
    """A ``rotate`` program (``build_program``) in a scenario matrix over
    two schemes: rows as the reference's, with telemetry on and off."""
    def drive(pkg, telemetry):
        prog = pkg.wl.build_program("rotate", svc=40.0, n_keys=600,
                                    phase_s=15.0)
        matrix = pkg.wl.ScenarioMatrix(
            schemes=["B3", "HHZS"], workloads=[], arrivals=[],
            drift_programs=[prog], ssd_zone_budgets=[20], warmup=2.0,
            db_factory=_factory(pkg, 600), telemetry=telemetry,
            **pkg.device)
        return matrix.run(verbose=False)
    on = _both(lambda pkg: drive(pkg, True))
    assert on == _both(lambda pkg: drive(pkg, False))
    assert {r["drift"] for r in on} == {"rotate~poisson"}


# ----------------------------------------------------------------------
# the serving grid
# ----------------------------------------------------------------------
def _serving_wl(pkg):
    return pkg.serving.ServingWorkload(
        name="chat", prompt_med=24, prompt_max=64, out_med=12, out_max=32,
        pause_prob=0.02, pause_mean=2.0, slo_ttft=2.0)


@pytest.mark.parametrize("policy", ["static", "lru", "hhzs"])
def test_serving_verify_step_matches_reference(policy):
    """Every resident KV page re-read after every decode step, the device
    tier's pages on the CPU: rows and manager stats as the reference's."""
    def drive(pkg):
        sv = pkg.serving
        arr = sv.serving_arrivals(("poisson",), 2.0)[0]
        res = sv.run_serving(
            [pkg.wl.TenantSpec("t0", _serving_wl(pkg), arr, protected=True,
                               slo_p99=2.0)],
            policy, pool=sv.ServingPool(hbm_zones=6, host_zones=48),
            duration=25.0, warmup=5.0, seed=3, verify="step",
            materialize=True, **pkg.device)
        return res.rows, res.stats
    rows, _ = _both(drive)
    assert rows[0]["n_completed"] > 0
    if policy != "static":
        assert rows[0]["demote_pages"] > 0


def test_bench_serving_grid_matches_reference():
    """``bench_serving``'s grid (3 policies x 2 arrivals x 2 device-tier
    sizes, 400 virtual seconds, telemetry on) through the sweep driver:
    every row as the reference's."""
    def drive(pkg):
        matrix = pkg.serving.build_serving_grid(
            policies=("static", "lru", "hhzs"),
            arrival_kinds=("poisson", "bursty"), hbm_zones=(10, 16),
            rate=2.5, duration=400.0, warmup=40.0, seed=1, telemetry=True,
            **pkg.device)
        return pkg.sweep.run_sweep(matrix, out=None, workers=0,
                                   resume=False, verbose=False)
    rows = _both(drive)
    assert len(rows) == 12 and {r["tiering"] for r in rows} == \
        {"static", "lru", "hhzs"}


def test_serving_needs_a_card_unless_asked_for_the_cpu():
    """``torch_device="cuda"`` (the default) never falls back to the CPU."""
    arr = pt_serving.serving_arrivals(("poisson",), 1.0)[0]
    tenants = [pt_wl.TenantSpec("t", _serving_wl(PORT), arr)]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_serving.run_serving(tenants, "hhzs", duration=5.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_sweep.GridDBFactory(key_div=2048)("HHZS", 20)
    assert pt_serving.run_serving(tenants, "hhzs", duration=5.0,
                                  torch_device="cpu").rows


def test_matrix_cells_mix_as_reference():
    """A matrix mixing YCSB, serving and drift cells enumerates the
    reference's cell names in the reference's order."""
    def drive(pkg):
        m = pkg.wl.ScenarioMatrix(
            schemes=["B3"], workloads=["A"],
            arrivals=[pkg.wl.PoissonArrivals(5.0)],
            serving_policies=("lru",),
            drift_programs=[pkg.wl.build_program("churn", svc=10.0,
                                                 n_keys=100)])
        return [c.name for c in m.cells()]
    assert len(_both(drive)) == 3


def test_phase_rankings_match_reference():
    """Per-phase scheme rankings and flips of synthetic drift rows (ties
    broken by scheme name, unmeasured windows skipped)."""
    rows = [{"drift": "p", "arrival": "poisson(1)", "tenant": "t0",
             "ssd_zones": 20, "scheme": s,
             "phases": [{"phase": k, "name": f"ph{k}", "latency_p99": v,
                         "throughput": 1.0 / v, "n_measured": m}
                        for k, v in enumerate(p99s)]}
            for s, p99s, m in (("A1", (1.0, 10.0, 5.0), 10),
                               ("B2", (2.0, 5.0, 6.0), 10),
                               ("C3", (2.0, 5.0, 6.0), 10),
                               ("D4", (0.5, 0.5, 0.5), 0))]

    def drive(pkg):
        return [{str(k): v for k, v in
                 pkg.wl.phase_rankings(rows, metric).items()}
                for metric in ("latency_p99", "throughput")] + \
            [{str(k): v for k, v in pkg.wl.rank_flips(rows).items()}]
    got = _both(drive)
    assert list(got[2].values()) == [2]


def test_numpy_streams_of_the_grid_builders_match_reference():
    """``arrivals_for_rate`` and ``serving_arrivals`` draw the reference's
    arrival times from the same seed."""
    def drive(pkg):
        rng = np.random.default_rng(4)
        arr = pkg.sweep.arrivals_for_rate(("poisson", "bursty", "ramp"),
                                          40.0)
        arr += pkg.serving.serving_arrivals(("poisson", "bursty", "flash"),
                                            2.0)
        return [[a.name, a.times(rng, 120.0).tolist()] for a in arr]
    assert len(_both(drive)) == 6
