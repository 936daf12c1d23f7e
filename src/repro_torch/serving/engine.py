"""Request metadata shared by the serving engines.

The dense ``Engine`` (slot-based continuous batching) is a later slice
of the port (ROADMAP Queue 1); this module carries the ``Request``
record and its wire form, which ``serving.paged`` imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    rid: str
    prompt: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    sensitivity: str = "public"      # public | personal | confidential
    priority: int = 0                # higher dispatches first / preempts
    deadline: Optional[float] = None  # absolute fleet-clock expiry
    quality_floor: float = 0.0       # min tier quality this request accepts
    tenant: str = ""                 # prefix-cache namespace ("" = default)
    done: bool = False
    output: list = field(default_factory=list)
    slot: int = -1


def request_to_dict(req: Request) -> dict:
    """Wire form of request metadata (workspace / slot snapshots)."""
    return {
        "rid": req.rid, "prompt": np.asarray(req.prompt).tolist(),
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature, "top_k": req.top_k,
        "sensitivity": req.sensitivity, "priority": req.priority,
        "deadline": req.deadline, "quality_floor": req.quality_floor,
        "tenant": req.tenant,
        "output": list(req.output),
        "slot": req.slot, "done": req.done,
    }


def request_from_dict(d: dict) -> Request:
    req = Request(rid=d["rid"], prompt=np.asarray(d["prompt"]),
                  max_new_tokens=d["max_new_tokens"],
                  temperature=d["temperature"], top_k=d["top_k"],
                  sensitivity=d["sensitivity"],
                  priority=d.get("priority", 0),
                  deadline=d.get("deadline"),
                  quality_floor=d.get("quality_floor", 0.0),
                  tenant=d.get("tenant", ""))
    req.output = list(d["output"])
    req.slot = d["slot"]
    req.done = d["done"]
    return req
