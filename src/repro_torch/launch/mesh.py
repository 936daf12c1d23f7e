"""The one card: the port's counterpart of the JAX package's
``launch/mesh.py`` (production meshes of 256 and 512 TPU chips).

The port runs on one NVIDIA H100, so there is no mesh and no
interconnect: a request for several chips (``multi_pod=True``, or a mesh)
raises and names the work that would bring one (ROADMAP Queue 1 item 8,
``sharding.py``).  The peak terms are the H100 SXM data sheet's, dense:
bf16 on the tensor cores, fp32 on the CUDA cores (no tensor cores), and
the HBM3 bandwidth; ``HBM_BYTES`` is the card's 80 GB.  ``chip_smoke.py``
takes its bounds from the same constants.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
MESH_NAME = "1xH100"
SHEET = "H100 SXM sheet"


@dataclass(frozen=True)
class Card:
    """The device the roofline describes: its name and power limit as
    ``nvidia-smi`` gives them when a card is present, else None; where
    the peak terms come from."""
    name: str | None
    power_limit: str | None
    source: str = SHEET


def production_device(*, multi_pod: bool = False, mesh=None) -> Card:
    """The port's production layout: one card, the one in this machine
    (``nvidia-smi --query-gpu=name,power.limit``), or the data sheet's
    where there is none.  ``multi_pod`` or a mesh raises
    ``NotImplementedError``."""
    if multi_pod or mesh is not None:
        raise NotImplementedError(
            "a multi-chip layout: the port runs on one card, with no mesh "
            "and no collective term (ROADMAP Queue 1 item 8, sharding.py)")
    if not torch.cuda.is_available():
        return Card(None, None)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return Card(name, limit)
