"""Testbed builder: assembles the full FIRST system (clusters, endpoints,
compute client, federation, auth, gateway, batch service) in one call.
Mirrors the paper's deployment: the Sophia-like cluster hosts the LLMs; a
second Polaris-like cluster joins for federation experiments.

A copy of the JAX package's ``repro/core/testbed.py``, unchanged in
behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core.auth import AccessPolicy, AuthService, CachingAuthClient
from repro_torch.core.autoscale import AutoScalePolicy
from repro_torch.core.batch import BatchService
from repro_torch.core.clock import EventLoop, VirtualClock
from repro_torch.core.compute import (ComputeClient, ComputeEndpoint,
                                      ModelDeployment)
from repro_torch.core.faults import FailureInjector, HealthMonitor
from repro_torch.core.federation import FederationRouter
from repro_torch.core.gateway import GatewayConfig, InferenceGateway
from repro_torch.core.metrics import MetricsLog
from repro_torch.core.scheduler import ClusterScheduler
from repro_torch.serving.costmodel import InstanceCost

# Cost-model stand-ins for the paper's benchmark models (llama-arch configs
# from public literature; used ONLY by the DES control-plane benchmarks —
# the 10 assigned architectures are served through the same machinery).
LLAMA70B = ModelConfig(
    name="llama3.3-70b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256, source="arXiv:2407.21783")
LLAMA8B = ModelConfig(
    name="llama3.1-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, source="arXiv:2407.21783")
GEMMA27B = ModelConfig(
    name="gemma-27b", family="dense", num_layers=46, d_model=4608,
    num_heads=32, num_kv_heads=16, head_dim=128, d_ff=36864,
    vocab_size=256000, source="arXiv:2408.00118")


@dataclass
class System:
    loop: EventLoop
    auth_service: AuthService
    auth: CachingAuthClient
    schedulers: dict
    endpoints: dict
    compute: ComputeClient
    router: FederationRouter
    gateway: InferenceGateway
    metrics: MetricsLog
    batch: BatchService
    health: HealthMonitor
    faults: FailureInjector
    tokens: dict = field(default_factory=dict)

    def token_for(self, user: str) -> str:
        if user not in self.tokens:
            self.auth_service.add_user(user, groups=("users",))
            self.tokens[user] = self.auth_service.issue_token(user)
        return self.tokens[user]


def default_deployment(cfg: ModelConfig, *, chips_per_instance: int = 8,
                       nodes_per_instance: int = 1, max_slots: int = 48,
                       max_instances: int = 1, idle_timeout: float = 7200.0,
                       model_shards: int = 1,
                       mfu: float = 0.5,
                       storage_bw: float = 2e9,
                       scale_cooldown: float = 30.0,
                       role: str = "unified",
                       min_hot: int = 0,
                       keepalive: float | None = None,
                       scale_in_cooldown: float = 30.0,
                       queue_threshold: int = 4,
                       result_cpu: float = 0.0,
                       prefix_cache_hit_rate: float = 0.0,
                       chunked_prefill_budget: int | None = None,
                       decode_steps_per_sync: int = 1,
                       scheduling_policy: str = "fcfs",
                       enable_preemption: bool = False,
                       restore_hit_rate: float = 1.0,
                       hw: dict | None = None) -> ModelDeployment:
    """``hw``: optional InstanceCost overrides, e.g. A100 constants
    ``dict(peak_flops=312e12, hbm_bw=1555e9)`` for paper-validation runs.
    ``model_shards``: tensor-parallel width per instance (must divide
    ``chips_per_instance``; InstanceCost validates) — adds the per-layer
    all-reduce terms to every service time, exactly as the real engine's
    ``EngineConfig.mesh`` shards its forward.
    ``role`` / ``min_hot`` / ``keepalive``: hot-pool + disaggregated
    serving knobs — see ``ModelDeployment`` and ``AutoScalePolicy``."""
    return ModelDeployment(
        model=cfg.name,
        role=role,
        cost=InstanceCost(cfg=cfg, chips=chips_per_instance, mfu=mfu,
                          storage_bw=storage_bw, model_shards=model_shards,
                          **(hw or {})),
        nodes_per_instance=nodes_per_instance,
        model_shards=model_shards,
        max_slots=max_slots,
        idle_timeout=idle_timeout,
        result_cpu=result_cpu,
        prefix_cache_hit_rate=prefix_cache_hit_rate,
        chunked_prefill_budget=chunked_prefill_budget,
        decode_steps_per_sync=decode_steps_per_sync,
        scheduling_policy=scheduling_policy,
        enable_preemption=enable_preemption,
        restore_hit_rate=restore_hit_rate,
        autoscale=AutoScalePolicy(max_instances=max_instances,
                                  cooldown=scale_cooldown,
                                  queue_threshold=queue_threshold,
                                  min_hot=min_hot,
                                  keepalive=keepalive,
                                  scale_in_cooldown=scale_in_cooldown),
    )


def build_system(
    deployments_by_cluster: dict[str, dict[str, ModelDeployment]] | None = None,
    *,
    nodes_per_cluster: int = 24,
    gateway_config: GatewayConfig | None = None,
    auth_latency: float = 2.0,
    auth_cache: bool = True,
    dispatch_latency: float = 0.15,
    connection_cache: bool = True,
    registry: dict[str, list[str]] | None = None,
    startup_delay: float = 20.0,
) -> System:
    """deployments_by_cluster: cluster -> {model_name: ModelDeployment}.
    Defaults to the paper's single-cluster Sophia deployment of Llama-70B."""
    loop = EventLoop(VirtualClock())
    if deployments_by_cluster is None:
        deployments_by_cluster = {
            "sophia": {LLAMA70B.name: default_deployment(LLAMA70B)}}

    auth_service = AuthService(loop, introspection_latency=auth_latency)
    auth = CachingAuthClient(loop, auth_service, enabled=auth_cache)
    compute = ComputeClient(loop, dispatch_latency=dispatch_latency,
                            result_latency=dispatch_latency,
                            connection_cache=connection_cache)
    schedulers = {}
    endpoints = {}
    for cluster, deps in deployments_by_cluster.items():
        sched = ClusterScheduler(loop, cluster, num_nodes=nodes_per_cluster,
                                 startup_delay=startup_delay)
        ep = ComputeEndpoint(loop, f"{cluster}-ep", sched, deps)
        schedulers[cluster] = sched
        endpoints[ep.endpoint_id] = ep
        compute.register_endpoint(ep)

    if registry is None:
        registry = {}
        for cluster, deps in deployments_by_cluster.items():
            for model in deps:
                registry.setdefault(model, []).append(f"{cluster}-ep")

    router = FederationRouter(endpoints, registry)
    for ep in endpoints.values():
        ep.attach_federation(router)   # prefill->decode handoff targeting
    metrics = MetricsLog()
    batch = BatchService(loop, router, endpoints)
    gateway = InferenceGateway(loop, auth, router, compute,
                               policy=AccessPolicy(),
                               config=gateway_config or GatewayConfig(),
                               metrics=metrics, batch=batch)
    health = HealthMonitor(loop, router)
    for ep in endpoints.values():
        health.watch(ep)          # endpoints emit real heartbeats
    faults = FailureInjector(loop)
    return System(loop=loop, auth_service=auth_service, auth=auth,
                  schedulers=schedulers, endpoints=endpoints, compute=compute,
                  router=router, gateway=gateway, metrics=metrics,
                  batch=batch, health=health, faults=faults)


def warm_up(system: System, model: str, instances: int = 1,
            user: str = "warm") -> None:
    """Bring ``instances`` hot instances up (and populate auth caches) before
    measuring — the paper's steady-state numbers are for hot models."""
    token = system.token_for(user)
    ep_id = system.router.select_endpoint(model)
    ep = system.endpoints[ep_id]
    for _ in range(instances - len(ep._alive_instances(model))):
        ep._spawn_instance(model)
    fut = system.gateway.submit(token, {
        "request_id": f"warm-{model}", "model": model,
        "prompt_tokens": 8, "max_tokens": 1})
    system.loop.run_until_idle()
    assert fut.done() and fut.error is None, f"warmup failed: {fut.error}"
    # drop the warmup from the metrics log
    system.metrics.records.clear()


def drive_workload(system: System, workload, model: str,
                   user: str = "bench") -> dict:
    """Submit a WorkloadRequest list through the gateway at their arrival
    times; run the loop until everything resolves. Returns metrics summary."""
    token = system.token_for(user)
    results = {}

    def _submit(w):
        fut = system.gateway.submit(token, {
            "request_id": w.request_id, "model": model,
            "prompt_tokens": w.prompt_tokens, "max_tokens": w.max_tokens,
        })
        fut.add_done_callback(lambda f: results.__setitem__(
            w.request_id, f.error or f.result()))

    for w in workload:
        system.loop.call_at(w.arrival, _submit, w)
    system.loop.run_until_idle()
    summary = system.metrics.summary()
    summary["errors"] = sum(1 for v in results.values()
                            if isinstance(v, Exception))
    return summary
