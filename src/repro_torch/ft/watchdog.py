"""Fault tolerance: heartbeats, straggler detection, elastic re-meshing.

Pure Python, the reference's module unchanged in behaviour (the port
keeps its own copy, as it imports nothing from the reference).

At thousand-node scale the failure model is: slow chips (stragglers),
dead hosts, and whole-pod losses.  The control-plane pieces here are
host-framework-agnostic and unit-tested in simulation:

  HeartbeatRegistry   workers report (step, wall time); the coordinator
                      flags stale heartbeats (dead) and step-laggards
                      (stragglers — candidates for hot-sparing).
  plan_elastic_mesh   given surviving chip count, pick the largest
                      (data, model) mesh the survivors can form while
                      keeping the model axis intact (TP groups must stay
                      whole; DP shrinks), and report the batch adjustment.
  TrainSupervisor     restart loop: run -> on failure restore the latest
                      checkpoint onto the new mesh (checkpoints are
                      mesh-shape agnostic, see repro_torch.checkpoint)
                      -> resume the data stream at the restored step
                      (deterministic (seed, step) indexing makes this
                      exact).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class Heartbeat:
    step: int
    t: float


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0, straggle_steps: int = 5):
        self.timeout = timeout_s
        self.straggle_steps = straggle_steps
        self.beats: Dict[str, Heartbeat] = {}

    def report(self, worker: str, step: int,
               t: Optional[float] = None) -> None:
        self.beats[worker] = Heartbeat(step=step, t=t if t is not None
                                       else time.monotonic())

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.monotonic()
        return [w for w, hb in self.beats.items()
                if now - hb.t > self.timeout]

    def stragglers(self) -> List[str]:
        if not self.beats:
            return []
        lead = max(hb.step for hb in self.beats.values())
        return [w for w, hb in self.beats.items()
                if lead - hb.step >= self.straggle_steps]


def plan_elastic_mesh(surviving_chips: int, model_parallel: int,
                      pods: int = 1) -> Tuple[Tuple[int, ...], float]:
    """Largest (pods?, data, model) mesh from survivors.

    The model axis is kept intact (a TP group is useless partially), the
    data axis shrinks to the largest whole multiple.  Returns (mesh shape,
    batch scale factor relative to full strength)."""
    if surviving_chips < model_parallel:
        raise RuntimeError("fewer chips than one model-parallel group")
    per_pod = surviving_chips // pods
    data = per_pod // model_parallel
    if data < 1:
        raise RuntimeError("cannot form a single data-parallel group")
    shape = (pods, data, model_parallel) if pods > 1 \
        else (data, model_parallel)
    full = pods * data * model_parallel
    return shape, full / surviving_chips if surviving_chips else 0.0


@dataclass
class TrainSupervisor:
    """Restart loop around a step function; used by launch/train.py and
    exercised in tests with injected failures."""
    save_every: int = 50
    max_restarts: int = 3
    restarts: int = 0
    events: List[str] = field(default_factory=list)

    def run(self, *, total_steps: int, start_step: int,
            run_steps: Callable[[int, int], int],
            save: Callable[[int], None],
            restore: Callable[[], int]) -> int:
        """run_steps(from, to) executes and returns the last completed step
        (raising on simulated/actual failure)."""
        step = start_step
        while step < total_steps:
            target = min(step + self.save_every, total_steps)
            try:
                step = run_steps(step, target)
                save(step)
            except Exception as e:      # noqa: BLE001 - restart on anything
                self.restarts += 1
                self.events.append(f"failure at ~{step}: {e}")
                if self.restarts > self.max_restarts:
                    raise
                step = restore()
                self.events.append(f"restored at {step}")
        return step
