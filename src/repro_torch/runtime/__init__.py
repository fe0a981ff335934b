"""Runtime of the port: the step builders (`runtime.step`: train,
prefill and serve), the injectable fault plane and straggler detection
(`runtime.fault`), and preemption-safe engine runs
(`runtime.resilience`)."""
from .fault import (FaultExhausted, FaultPlane, FaultSpec, InjectedFault,
                    Preempted, RecoveryPlan, StragglerConfig,
                    StragglerDetector, plan_recovery)
from .resilience import (ResilienceConfig, ResilientRun, RunProgress,
                         host_lane_mask, maybe_resilient, metrics_restore,
                         plan_restore, plan_state, probe_restore,
                         probe_state, resume_group, row_restore, row_state,
                         run_signature)

__all__ = [
    "FaultExhausted", "FaultPlane", "FaultSpec", "InjectedFault",
    "Preempted", "RecoveryPlan", "StragglerConfig", "StragglerDetector",
    "plan_recovery",
    "ResilienceConfig", "ResilientRun", "RunProgress", "host_lane_mask",
    "maybe_resilient", "metrics_restore", "plan_restore", "plan_state",
    "probe_restore", "probe_state", "resume_group", "row_restore",
    "row_state", "run_signature",
]
