from .ycsb import (YCSB, WorkloadSpec, WorkloadResult, Ops, OpStream,
                   collect_extras, generate_ops, run_load, run_workload,
                   mixed, zipf_probs, LevelSampler,
                   READ, UPDATE, INSERT, SCAN, RMW)
from .runner import (ArrivalProcess, PoissonArrivals, BurstyArrivals,
                     RampArrivals, DiurnalArrivals, FlashCrowdArrivals,
                     OpenLoopResult, run_open_loop)

__all__ = [
    "YCSB", "WorkloadSpec", "WorkloadResult", "Ops", "OpStream",
    "collect_extras", "generate_ops", "run_load", "run_workload",
    "mixed", "zipf_probs", "LevelSampler",
    "READ", "UPDATE", "INSERT", "SCAN", "RMW",
    "ArrivalProcess", "PoissonArrivals", "BurstyArrivals", "RampArrivals",
    "DiurnalArrivals", "FlashCrowdArrivals",
    "OpenLoopResult", "run_open_loop",
]
