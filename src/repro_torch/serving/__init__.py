from repro_torch.serving.engine import (Engine, EngineState, Request,
                                        SlotArrays, SlotSnapshot,
                                        request_from_dict, request_to_dict)
from repro_torch.serving.prefix_cache import (PrefixCache, PrefixNode,
                                              PrefixStats)

__all__ = [
    "Engine", "EngineState", "Request", "SlotArrays", "SlotSnapshot",
    "request_from_dict", "request_to_dict",
    "PrefixCache", "PrefixNode", "PrefixStats",
]
