"""AgentWorkspace: the migratable unit of MVVM (paper §2.1).

Everything an agent needs to resume exactly where it stopped:
  * engine_state  -- KV caches / SSM states, generated tokens, per-slot
                     positions, sampling RNG keys, step counter
                     (serving.EngineState; the "WASM locals + stack")
  * requests      -- in-flight request metadata (the "tool state")
  * measurement   -- config + weight Merkle root (binds state to model)
  * vclock        -- vector clock for replica synchronization
  * phase/step    -- the stable-point instruction pointer analogue

This is the port's copy: ``engine_state`` is the port's ``EngineState``
(tensors on the engine's device, the rng pairs on the CPU).  The
engine updates its state in place, so ``from_engine`` takes a copy: a
workspace is the state at its stable point, as in the JAX package,
where arrays are immutable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.tree import tree_map
from repro_torch.serving.engine import (Engine, EngineState,
                                        request_from_dict, request_to_dict)


@dataclass
class VectorClock:
    clocks: dict[str, int] = field(default_factory=dict)

    def tick(self, node: str) -> "VectorClock":
        c = dict(self.clocks)
        c[node] = c.get(node, 0) + 1
        return VectorClock(c)

    def merge(self, other: "VectorClock") -> "VectorClock":
        keys = set(self.clocks) | set(other.clocks)
        return VectorClock({k: max(self.clocks.get(k, 0),
                                   other.clocks.get(k, 0)) for k in keys})

    def dominates(self, other: "VectorClock") -> bool:
        keys = set(self.clocks) | set(other.clocks)
        return all(self.clocks.get(k, 0) >= other.clocks.get(k, 0)
                   for k in keys)

    def concurrent(self, other: "VectorClock") -> bool:
        return not self.dominates(other) and not other.dominates(self)


@dataclass
class AgentWorkspace:
    engine_state: EngineState
    requests: list[dict]
    config_name: str
    measurement: str                  # global_id binding state to model
    phase: str = "decode"             # stable-point phase
    step: int = 0                     # stable-point index within phase
    vclock: VectorClock = field(default_factory=VectorClock)

    @classmethod
    def from_engine(cls, engine: Engine, measurement: str,
                    node: str = "src") -> "AgentWorkspace":
        reqs = [request_to_dict(r) for r in engine.requests.values()]
        state = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                         else x, engine.state)
        return cls(engine_state=state, requests=reqs,
                   config_name=engine.cfg.name, measurement=measurement,
                   step=int(engine.state.step_count),
                   vclock=VectorClock().tick(node))

    def attach(self, engine: Engine) -> Engine:
        """Install this workspace into a compatible engine (restore)."""
        if engine.cfg.name.split("-tiny")[0] != \
                self.config_name.split("-tiny")[0]:
            raise ValueError(f"config mismatch: {engine.cfg.name} != "
                             f"{self.config_name}")
        engine.state = self.engine_state
        engine.requests = {}
        for r in self.requests:
            req = request_from_dict(r)
            if not req.done:
                engine.requests[req.slot] = req
        return engine
