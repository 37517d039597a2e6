"""Request / response dataclasses (OpenAI-completions-shaped)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

_req_counter = itertools.count()


@dataclass
class SamplingParams:
    max_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    top_p: float = 1.0
    seed: int = 0
    stop_token: Optional[int] = None


@dataclass
class InferenceRequest:
    model: str
    prompt_tokens: list                       # list[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = ""
    user: str = "anonymous"
    arrival_time: float = 0.0
    api_endpoint: str = "chat/completions"    # chat/completions|completions|embeddings
    # QoS routing/scheduling fields, threaded gateway -> engine (see
    # serving/scheduler.py): workload class, intra-class priority (lower =
    # more urgent), and absolute TTFT deadline (clock time; None = none)
    qos: str = "interactive"                  # interactive | batch
    priority: int = 0
    deadline: Optional[float] = None

    def __post_init__(self):
        if not self.request_id:
            self.request_id = f"req-{next(_req_counter)}"


@dataclass
class RequestMetrics:
    arrival_time: float = 0.0
    queued_time: float = 0.0       # entered engine queue
    admitted_time: float = 0.0     # left the queue (last admission)
    first_token_time: float = 0.0
    finish_time: float = 0.0
    cached_prompt_tokens: int = 0  # prompt tokens served from the prefix cache
    prefill_chunks: int = 0        # engine steps this prompt's ingest spanned
    preemptions: int = 0           # times this request was evicted mid-run
    restore_cached_tokens: int = 0  # restore-prefill tokens the cache covered

    @property
    def ttft(self):
        return self.first_token_time - self.arrival_time

    @property
    def e2e_latency(self):
        return self.finish_time - self.arrival_time


@dataclass
class RequestOutput:
    request_id: str
    output_tokens: list = field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    error: str = ""

    @property
    def num_output_tokens(self):
        return len(self.output_tokens)
