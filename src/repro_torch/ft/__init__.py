from .watchdog import (HeartbeatRegistry, plan_elastic_mesh,
                       TrainSupervisor)

__all__ = ["HeartbeatRegistry", "plan_elastic_mesh", "TrainSupervisor"]
