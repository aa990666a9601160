"""The serve fabric's runtime: fault injection, straggler detection, the
in-process supervisor and the cross-process one with its transport and
worker loop; and the fault-tolerant trainer.  The policy modules use numpy
and the standard library only; replicas come from an injected factory
(in-process) or a spawn function (worker processes), so the policy runs
without a model or a device."""
from repro_torch.runtime.fabric import (  # noqa: F401
    CrossProcessFabric,
    FabricConfig,
    Request,
    Result,
    ServeFabric,
    XFabricConfig,
)
from repro_torch.runtime.faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    ReplicaCrash,
    ReplicaFault,
    RequestRejected,
    TransientLaunchError,
    parse_faults,
    split_process_specs,
)
from repro_torch.runtime.straggler import Mitigation, StragglerDetector  # noqa: F401
from repro_torch.runtime.trainer import FailureInjector, Trainer, TrainerConfig  # noqa: F401
from repro_torch.runtime.transport import (  # noqa: F401
    LoopbackHandle,
    ManualClock,
    MonotonicClock,
    ProcessHandle,
    SlowPipe,
    make_process_spawn,
)
from repro_torch.runtime.worker import SyntheticReplica, WorkerLoop, make_loopback_spawn  # noqa: F401
