"""Fleet orchestration over the port's engines: N heterogeneous Engine /
PagedEngine replicas, one request stream (the cluster-level layer over
the pairwise MVVM primitives), in sync mode.

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

The JAX package's service mode (``service``, ``bus``) and its
``autoscaler`` are not ported yet (ROADMAP Queue 1).

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
from repro_torch.fleet.balancer import Rebalancer
from repro_torch.fleet.cluster import EngineHandle, FleetController
from repro_torch.fleet.lifecycle import (DeadlineExpired, LifecycleError,
                                         LifecycleEvent, RequestCancelled,
                                         RequestFailed, RequestSpec,
                                         RequestState, RequestTicket,
                                         TERMINAL_STATES)
from repro_torch.fleet.router import RouteDecision, Router
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
    "DeadlineExpired", "EngineHandle", "FULL_TIER", "FleetController",
    "FleetTelemetry", "LifecycleError", "LifecycleEvent",
    "MigrationRecord", "QualityEvent", "QualityTier", "Rebalancer",
    "RequestCancelled", "RequestFailed", "RequestSpec", "RequestState",
    "RequestTicket", "RouteDecision", "Router", "SpecTierStats",
    "SpeculativeTierController", "TERMINAL_STATES", "Tracer",
]
