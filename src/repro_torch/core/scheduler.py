"""PBS/Slurm-analogue cluster scheduler (discrete-event simulation).

Models what FIRST sees from an HPC batch system: a fixed pool of accelerator
nodes, a FIFO job queue with optional backfill, node-acquisition delay, and a
public status API (used by the federation layer, paper §4.5: "queries the
publicly available status of each cluster").

A copy of the JAX package's ``repro/core/scheduler.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum

_job_ids = itertools.count(1)


class JobState(str, Enum):
    QUEUED = "queued"
    STARTING = "starting"
    RUNNING = "running"
    ENDED = "ended"
    FAILED = "failed"


@dataclass
class Job:
    num_nodes: int
    walltime: float | None
    on_start: object
    on_end: object = None
    job_id: int = field(default_factory=lambda: next(_job_ids))
    state: JobState = JobState.QUEUED
    nodes: list = field(default_factory=list)
    submit_time: float = 0.0
    start_time: float = 0.0
    end_time: float = 0.0

    @property
    def queue_wait(self) -> float:
        return self.start_time - self.submit_time


class ClusterScheduler:
    def __init__(self, loop, name: str, num_nodes: int,
                 chips_per_node: int = 8, startup_delay: float = 20.0,
                 backfill: bool = True):
        self.loop = loop
        self.name = name
        self.num_nodes = num_nodes
        self.chips_per_node = chips_per_node
        self.startup_delay = startup_delay   # node boot + env setup
        self.backfill = backfill
        self._free_nodes = list(range(num_nodes))
        self._queue: list[Job] = []
        self.jobs: dict[int, Job] = {}
        self._down_nodes: set[int] = set()

    # -- public API (what FIRST's endpoint calls) ------------------------------
    def submit(self, num_nodes: int, on_start, on_end=None,
               walltime: float | None = None) -> Job:
        job = Job(num_nodes=num_nodes, walltime=walltime, on_start=on_start,
                  on_end=on_end)
        job.submit_time = self.loop.now()
        self.jobs[job.job_id] = job
        self._queue.append(job)
        self._try_schedule()
        return job

    def release(self, job: Job):
        """Job gives back its nodes (endpoint idle-release or shutdown)."""
        if job.state in (JobState.ENDED, JobState.FAILED):
            return
        if job.state == JobState.QUEUED:
            # a queued job must leave the queue when released, or
            # _try_schedule would later zombie-start an ENDED job and leak
            # its nodes forever (caught by the hypothesis scheduler
            # property: terminal states are terminal)
            self._end_queued(job)
            return
        self._finish(job, JobState.ENDED)

    def cancel(self, job: Job):
        if job.state == JobState.QUEUED:
            self._end_queued(job)

    def _end_queued(self, job: Job):
        """Terminal transition for a job that never started: dequeue, mark
        ENDED, and fire on_end — one code path for release() and cancel()."""
        self._queue.remove(job)
        job.state = JobState.ENDED
        job.end_time = self.loop.now()
        if job.on_end:
            job.on_end(job)

    # -- status (federation reads this) ------------------------------------------
    def available_nodes(self) -> int:
        return len(self._free_nodes)

    def queue_depth(self) -> int:
        return len(self._queue)

    def status(self) -> dict:
        return {
            "cluster": self.name,
            "nodes_total": self.num_nodes,
            "nodes_free": self.available_nodes(),
            "nodes_down": len(self._down_nodes),
            "queue_depth": self.queue_depth(),
        }

    # -- fault hooks -----------------------------------------------------------
    def fail_node(self, node_id: int):
        """Hard node failure: kills the job running on it."""
        self._down_nodes.add(node_id)
        if node_id in self._free_nodes:
            self._free_nodes.remove(node_id)
            return None
        for job in self.jobs.values():
            if job.state in (JobState.STARTING, JobState.RUNNING) \
                    and node_id in job.nodes:
                self._finish(job, JobState.FAILED, lost_node=node_id)
                return job
        return None

    def restore_node(self, node_id: int):
        if node_id in self._down_nodes:
            self._down_nodes.remove(node_id)
            self._free_nodes.append(node_id)
            self._try_schedule()

    # -- internals -----------------------------------------------------------
    def _try_schedule(self):
        i = 0
        while i < len(self._queue):
            job = self._queue[i]
            if job.num_nodes <= len(self._free_nodes):
                self._queue.pop(i)
                self._start(job)
                continue
            if not self.backfill:
                break
            i += 1

    def _start(self, job: Job):
        job.nodes = [self._free_nodes.pop() for _ in range(job.num_nodes)]
        job.state = JobState.STARTING
        job.start_time = self.loop.now()

        def _running():
            if job.state != JobState.STARTING:
                return
            job.state = JobState.RUNNING
            if job.on_start:
                job.on_start(job)
            if job.walltime is not None:
                self.loop.call_after(job.walltime, self._walltime_end, job)

        self.loop.call_after(self.startup_delay, _running)

    def _walltime_end(self, job: Job):
        if job.state == JobState.RUNNING:
            self._finish(job, JobState.ENDED)

    def _finish(self, job: Job, state: JobState, lost_node: int | None = None):
        job.state = state
        job.end_time = self.loop.now()
        for n in job.nodes:
            if n != lost_node and n not in self._down_nodes:
                self._free_nodes.append(n)
        job.nodes = []
        if job.on_end:
            job.on_end(job)
        self._try_schedule()
