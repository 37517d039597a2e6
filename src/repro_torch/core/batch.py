"""Batch mode (paper §4.4): a batch job runs as a DEDICATED cluster job that
loads the model solely for that task and processes the whole input file
offline — no shared online server, cold start amortized over the batch.

The /v1/batches surface wraps this in the OpenAI Batch API shape: submit an
NDJSON-style list of ``BatchItem``s (each a typed /v1 request body), poll a
``BatchStatus`` object, and retrieve per-request results — completed items
carry a typed response with usage accounting, invalid items carry a typed
error instead of failing the whole batch.

A copy of the JAX package's ``repro/core/batch.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum

from repro_torch.api import schemas
from repro_torch.api.errors import APIError, InvalidRequestError
from repro_torch.core.clock import Future
from repro_torch.core.instances import ModelInstance, SimRequest

_batch_ids = itertools.count(1)


class BatchState(str, Enum):
    VALIDATING = "validating"
    QUEUED = "queued"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class BatchJob:
    batch_id: str
    model: str
    total: int
    state: BatchState = BatchState.VALIDATING
    completed: int = 0
    failed: int = 0
    output_tokens: int = 0
    submit_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    user: str = ""
    future: Future = field(default_factory=Future)
    # custom_id -> {"response": typed response} | {"error": APIError dict}
    results_by_id: dict = field(default_factory=dict)

    def batch_status(self) -> schemas.BatchStatus:
        return schemas.BatchStatus(
            id=self.batch_id, status=self.state.value, model=self.model,
            created_at=self.submit_time, in_progress_at=self.start_time,
            completed_at=self.finish_time, total=self.total,
            completed=self.completed, failed=self.failed,
            output_tokens=self.output_tokens)

    def status(self) -> schemas.BatchStatus:
        """Legacy name; the returned BatchStatus also supports the old
        dict keys (``state``/``completed``/``total``/``output_tokens``)."""
        return self.batch_status()


class BatchService:
    """The /v1/batches endpoint backend."""

    def __init__(self, loop, router, endpoints, offline_slots: int = 256):
        self.loop = loop
        self.router = router
        self.endpoints = endpoints
        self.offline_slots = offline_slots
        self.jobs: dict[str, BatchJob] = {}

    # -- legacy entry point -----------------------------------------------------
    def submit_batch(self, model: str, requests: list[dict],
                     endpoint_id: str | None = None) -> BatchJob:
        """Pre-/v1 shape: JSONL-like dicts with request_id / prompt_tokens /
        max_tokens. Converted into typed BatchItems and served by
        ``create``."""
        items = []
        for r in requests:
            items.append(schemas.BatchItem(
                custom_id=str(r.get("request_id", f"item-{len(items)}")),
                body=dict(r, model=model)))
        return self.create(schemas.BatchRequest(items=items),
                           endpoint_id=endpoint_id)

    # -- /v1/batches ------------------------------------------------------------
    def create(self, request: schemas.BatchRequest,
               endpoint_id: str | None = None, user: str = "") -> BatchJob:
        bid = f"batch-{next(_batch_ids)}"
        model = request.model
        job = BatchJob(batch_id=bid, model=model, total=len(request.items),
                       submit_time=self.loop.now(), user=user)
        self.jobs[bid] = job
        if not request.items:
            job.state = BatchState.FAILED
            job.future.set_error(InvalidRequestError("empty batch"))
            return job

        # per-item parse + validation (BatchItem defers both): broken
        # items become per-request errors, the rest of the batch still
        # runs (OpenAI batch semantics)
        valid: list[tuple[schemas.BatchItem, object]] = []
        for it in request.items:
            try:
                valid.append((it, it.parsed_body()))
            except APIError as e:
                job.failed += 1
                job.results_by_id[it.custom_id] = {"error": e.to_dict()}
        if not valid:
            job.state = BatchState.FAILED
            job.finish_time = self.loop.now()
            job.future.set_error(InvalidRequestError(
                "every batch item failed validation"))
            return job

        ep_id = endpoint_id or self.router.select_endpoint(model, qos="batch")
        ep = self.endpoints[ep_id]
        dep = ep.deployments[model]
        job.state = BatchState.QUEUED

        # Dedicated instance: no idle timeout (released explicitly at the end),
        # offline-sized batch slots, loads the model solely for this job.
        inst = ModelInstance(
            self.loop, model, dep.cost, ep.scheduler,
            num_nodes=dep.nodes_per_instance, max_slots=self.offline_slots,
            idle_timeout=None)

        def on_done(item, body, result):
            job.completed += 1
            job.output_tokens += result["output_tokens"]
            result = dict(result, endpoint=ep_id)
            resp = schemas.response_from_result(body, result,
                                                job.submit_time)
            job.results_by_id[item.custom_id] = {"response": resp}
            if job.state == BatchState.QUEUED:
                job.state = BatchState.IN_PROGRESS
            if job.completed + job.failed >= job.total:
                job.state = BatchState.COMPLETED
                job.finish_time = self.loop.now()
                inst.release()
                job.future.set_result(job.batch_status())

        def on_first(t):
            if not job.start_time:
                job.start_time = t
                job.state = BatchState.IN_PROGRESS

        for it, body in valid:
            # batch jobs carry the batch QoS class end-to-end: on a shared
            # online engine (priority/preemption policies) they yield to
            # interactive traffic; on this dedicated instance the tag is
            # inert but keeps the accounting uniform
            sreq = SimRequest(request_id=body.request_id or it.custom_id,
                              prompt_tokens=body.prompt_token_count,
                              max_tokens=int(body.max_tokens),
                              user=user or body.user or "anonymous",
                              qos="batch",
                              priority=body.priority)
            inst.submit(sreq, on_first,
                        lambda result, it=it, body=body:
                            on_done(it, body, result))
        return job

    def status(self, batch_id: str) -> schemas.BatchStatus:
        job = self.jobs.get(batch_id)
        if job is None:
            return schemas.BatchStatus(id=batch_id, status="not_found")
        return job.batch_status()

    def results(self, batch_id: str) -> list[dict]:
        """Per-request outcomes in submission order of completion:
        ``{"custom_id", "response"}`` or ``{"custom_id", "error"}``."""
        job = self.jobs.get(batch_id)
        if job is None:
            return []
        return [{"custom_id": cid, **outcome}
                for cid, outcome in job.results_by_id.items()]
