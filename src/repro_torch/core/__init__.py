"""FIRST control plane — the paper's primary contribution: gateway,
FaaS compute layer, scheduling (hot nodes, auto-scaling, batch mode),
federation, and fault tolerance, all driven by one discrete-event loop.

A copy of the JAX package's ``repro/core/__init__.py``, unchanged in
behaviour.
"""
from repro_torch.core.clock import EventLoop, Future, RealClock, VirtualClock
from repro_torch.core.auth import (AccessPolicy, AuthError, AuthService,
                                   CachingAuthClient, Identity)
from repro_torch.core.metrics import MetricsLog, RequestRecord
from repro_torch.core.scheduler import ClusterScheduler, Job, JobState
from repro_torch.core.instances import (InstanceState, ModelInstance,
                                        SimEngine, SimRequest)
from repro_torch.core.autoscale import AutoScalePolicy, AutoScaler
from repro_torch.core.compute import (ComputeClient, ComputeEndpoint,
                                      ComputeError, ModelDeployment)
from repro_torch.core.federation import FederationError, FederationRouter
from repro_torch.core.gateway import (GatewayConfig, GatewayError,
                                      InferenceGateway, RateLimiter,
                                      ResponseCache, WorkerPool)
from repro_torch.core.batch import BatchJob, BatchService, BatchState
from repro_torch.core.faults import FailureInjector, HealthMonitor

__all__ = [
    "EventLoop", "Future", "RealClock", "VirtualClock",
    "AccessPolicy", "AuthError", "AuthService", "CachingAuthClient", "Identity",
    "MetricsLog", "RequestRecord",
    "ClusterScheduler", "Job", "JobState",
    "InstanceState", "ModelInstance", "SimEngine", "SimRequest",
    "AutoScalePolicy", "AutoScaler",
    "ComputeClient", "ComputeEndpoint", "ComputeError", "ModelDeployment",
    "FederationError", "FederationRouter",
    "GatewayConfig", "GatewayError", "InferenceGateway", "RateLimiter",
    "ResponseCache", "WorkerPool",
    "BatchJob", "BatchService", "BatchState",
    "FailureInjector", "HealthMonitor",
]
