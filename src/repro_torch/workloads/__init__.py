from .ycsb import (YCSB, WorkloadSpec, WorkloadResult, Ops, OpStream,
                   collect_extras, generate_ops, run_load, run_workload,
                   mixed, zipf_probs, LevelSampler,
                   READ, UPDATE, INSERT, SCAN, RMW)
from .runner import (ArrivalProcess, PoissonArrivals, BurstyArrivals,
                     RampArrivals, DiurnalArrivals, FlashCrowdArrivals,
                     OpenLoopResult, run_open_loop,
                     TenantSpec, MultiTenantResult, run_multi_tenant,
                     ScenarioCell, MultiTenantCell, ScenarioMatrix)
from .serving import (ServingWorkload, ServingPool, ServingCosts,
                      ServingCell, ServingResult, run_serving,
                      serving_arrivals, build_serving_grid)
from .drift import (Phase, DriftTenant, TraceProgram, DriftCell,
                    run_drift, build_program, PROGRAM_BUILDERS,
                    inject_scan_burst, phase_rankings, rank_flips)
# NOTE: the sweep driver (``repro_torch.workloads.sweep``) is imported
# explicitly, not re-exported here — it doubles as
# `python -m repro_torch.workloads.sweep` and importing it at package load
# would shadow that entry point.  repro_torch.workloads.serving is ALSO a
# `-m` entry point, but its module body only defines the grid (main() runs
# under __main__), so re-exporting the specs here is safe.

__all__ = [
    "YCSB", "WorkloadSpec", "WorkloadResult", "Ops", "OpStream",
    "collect_extras", "generate_ops", "run_load", "run_workload",
    "mixed", "zipf_probs", "LevelSampler",
    "READ", "UPDATE", "INSERT", "SCAN", "RMW",
    "ArrivalProcess", "PoissonArrivals", "BurstyArrivals", "RampArrivals",
    "DiurnalArrivals", "FlashCrowdArrivals",
    "OpenLoopResult", "run_open_loop",
    "TenantSpec", "MultiTenantResult", "run_multi_tenant",
    "ScenarioCell", "MultiTenantCell", "ScenarioMatrix",
    "ServingWorkload", "ServingPool", "ServingCosts", "ServingCell",
    "ServingResult", "run_serving", "serving_arrivals",
    "build_serving_grid",
    "Phase", "DriftTenant", "TraceProgram", "DriftCell", "run_drift",
    "build_program", "PROGRAM_BUILDERS", "inject_scan_burst",
    "phase_rankings", "rank_flips",
]
