"""Fleet orchestration over the port's engines: N heterogeneous Engine /
PagedEngine replicas, one request stream (the cluster-level layer over
the pairwise MVVM primitives).

lifecycle   -- the request-lifecycle API: immutable RequestSpec
               (priority, deadline) in, RequestTicket out -- a typed
               state machine with token streaming, cancel(), blocking
               result(), and preemption-by-migration semantics
cluster     -- FleetController: engine registry, admission control,
               priority-ordered dispatch with preemption via the
               migration machinery, deadline expiry, the fleet step loop
router      -- sensitivity/attestation gates composed with roofline cost,
               per-engine load, and deadline urgency
balancer    -- shadow checkpoints, failure-driven re-placement, planned
               live migration of individual in-flight slots
telemetry   -- per-engine + fleet tokens/s, latency percentiles,
               queue-wait/preemption latencies, migration audit log,
               per-tier SLO roll-ups, and the unified lifecycle event
               log (stored in the tracing metrics registry)
tracing     -- distributed tracing + metrics: per-request span trees
               derived from the audit log (trace context rides the
               pack_slot wire format across migration hops), each
               program's first run attributed as a ``jit:`` span,
               Chrome trace-event and Prometheus text exporters, and
               the bounded windowed-histogram MetricsRegistry
speculative -- draft/verify tier pairs: draft on an edge engine, slot
               hand-off over the attested wire (heterogeneous max_len
               via migration.repack_slot), verification on a cloud
               engine with rejected suffixes bounced back

service     -- the control-plane/service split: ControlPlane owns
               membership, tickets, admission and routing while each
               engine runs inside an EngineService pulling work from a
               per-engine mailbox on its own thread; placement,
               migration and heartbeats travel as messages over a
               pluggable bus transport
bus         -- the message layer under service mode: msgpack-framed
               Message envelopes (byte for byte the JAX package's),
               per-engine Mailboxes, MessageBus over a core.channel
               Transport, receiver-side DedupCache and the heartbeat
               FailureDetector (typed HeartbeatLoss events)
autoscaler  -- elastic pool membership: per-tier EngineTemplate pools +
               ScalePolicy drive spawn at the tier the backlog needs and
               drain-then-retire (scaling is migration), typed
               ScaleEvents on the unified audit log, and a warm-standby
               pool promoted on scale-up and prefix-prewarmed from a
               same-tier donor

Quality tiers (core.replication.QualityTier) are a first-class routing
dimension: engines carry a tier (distinct weights -- full bf16, int8,
small model), requests carry a quality_floor, the router degrades to a
lower-but-acceptable tier under saturation / deadline pressure / link
failure (typed QualityEvents on the audit log), cross-tier hand-offs
re-prefill the committed stream (lossy -- bit-exactness is a same-tier
property), and the speculative controller's "distribution" verify mode
runs standard speculative-sampling accept/reject so a distinct-weights
draft tier still commits target-distributed output.
"""

from repro_torch.core.replication import FULL_TIER, QualityTier
from repro_torch.fleet.autoscaler import (Autoscaler, EngineTemplate,
                                          ScaleEvent, ScalePolicy,
                                          ScaleSignals)
from repro_torch.fleet.balancer import Rebalancer
from repro_torch.fleet.cluster import EngineHandle, FleetController
from repro_torch.fleet.lifecycle import (DeadlineExpired, LifecycleError,
                                         LifecycleEvent, RequestCancelled,
                                         RequestFailed, RequestSpec,
                                         RequestState, RequestTicket,
                                         TERMINAL_STATES)
from repro_torch.fleet.bus import (DedupCache,  # noqa: F401
                                   FailureDetector, HeartbeatLoss, Mailbox,
                                   Message, MessageBus)
from repro_torch.fleet.router import RouteDecision, Router
from repro_torch.fleet.service import ControlPlane, EngineService
from repro_torch.fleet.speculative import (SpecTierStats,
                                           SpeculativeTierController)
from repro_torch.fleet.telemetry import (FleetTelemetry, MigrationRecord,
                                         QualityEvent)
from repro_torch.fleet.tracing import Tracer

# internal plumbing kept importable at the package root, as in the JAX
# package; not part of the blessed __all__ surface
from repro_torch.fleet.balancer import peek_slot_meta  # noqa: F401
from repro_torch.fleet.lifecycle import (WorkItem, WorkQueue,  # noqa: F401
                                         effective_priority, work_order)
from repro_torch.fleet.telemetry import EngineStats, percentile  # noqa: F401
from repro_torch.fleet.tracing import (Counter, Gauge,  # noqa: F401
                                       MetricsRegistry, Span,
                                       WindowedHistogram)

__all__ = [
    "Autoscaler", "ControlPlane", "DeadlineExpired", "EngineHandle",
    "EngineService", "EngineTemplate", "FULL_TIER", "FailureDetector",
    "FleetController", "FleetTelemetry", "HeartbeatLoss",
    "LifecycleError", "LifecycleEvent", "Message", "MessageBus",
    "MigrationRecord", "QualityEvent", "QualityTier", "Rebalancer",
    "RequestCancelled", "RequestFailed", "RequestSpec", "RequestState",
    "RequestTicket", "RouteDecision", "Router", "ScaleEvent",
    "ScalePolicy", "ScaleSignals", "SpecTierStats",
    "SpeculativeTierController", "TERMINAL_STATES", "Tracer",
]
