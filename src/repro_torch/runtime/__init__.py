"""The serve fabric's runtime: fault injection, straggler detection and the
in-process supervisor.  These modules use numpy only; replicas come from an
injected factory, so the policy runs without a model or a device."""
from repro_torch.runtime.fabric import FabricConfig, Request, Result, ServeFabric  # noqa: F401
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
