"""Service mode under bulk traffic on the CPU: three dense ``Engine``
services over ``SocketTransport`` shipping a shadow of every live slot
every step (the fleet CLI's ``--sync-every 1``), with slots of about 100
MB (tiny llama at d_model 1024, ``max_len`` 24576 by default).

    PYTHONPATH=src python scripts/socket_fleet_stress.py [--max-len N]
        [--one-lane] [--chunked]

``--one-lane`` sends every frame of a pair on one connection, as the
JAX package's transport does: a heartbeat then waits behind a shadow's
``sendall``, which takes the GIL back once a socket buffer while the
engine threads run.  ``--chunked`` reads each frame in socket-sized
chunks, as the JAX package's reader does, instead of in one
``MSG_WAITALL`` recv.  Prints the requests served, the wall seconds,
the heartbeat losses, the largest shadow and the RPC retries.  Needs
about 4 GB of host memory at the default size.
"""

import argparse
import socket
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core import channel  # noqa: E402
from repro_torch.core.attestation import TrustAuthority  # noqa: E402
from repro_torch.core.daemon import CLOUD  # noqa: E402
from repro_torch.fleet import (ControlPlane, EngineHandle,  # noqa: E402
                               FleetController, RequestSpec)
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402


def _chunked_recv(sock, n):
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except OSError:
            return None
        if not k:
            return None
        got += k
    return buf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-len", type=int, default=24576)
    ap.add_argument("--one-lane", action="store_true")
    ap.add_argument("--chunked", action="store_true")
    args = ap.parse_args(argv)
    if args.one_lane:
        channel.SocketTransport.BULK_BYTES = 1 << 62
    if args.chunked:
        channel.SocketTransport._recv_exact = staticmethod(_chunked_recv)
    cfg = make_tiny(get("llama-1.5b"), d_model=1024)
    params = init_params(cfg, torch.Generator("cpu").manual_seed(0),
                         device="cpu")
    handles = [EngineHandle(n, Engine(cfg, params, slots=4,
                                      max_len=args.max_len, seed=i,
                                      device="cpu"), CLOUD)
               for i, n in enumerate("abc")]
    fleet = FleetController(handles, authority=TrustAuthority())
    cp = ControlPlane(fleet, transport=channel.SocketTransport(),
                      sync_every=1)
    cp.start(threads=True)
    rng = np.random.default_rng(0)
    specs = [RequestSpec(rid=f"r{i}",
                         prompt=rng.integers(5, cfg.vocab_size, 8),
                         max_new_tokens=16) for i in range(9)]
    t0 = time.perf_counter()
    try:
        out = cp.serve(specs, timeout_s=240)
    finally:
        cp.stop()
    print(f"served {len(out)}/9 in {time.perf_counter() - t0:.1f} s, "
          f"heartbeat losses {fleet.telemetry.heartbeat_losses}, largest "
          f"shadow {cp.bus.largest.get('shadow')} bytes, RPC retries "
          f"{cp.retried}")
    return 0 if len(out) == len(specs) else 1


if __name__ == "__main__":
    sys.exit(main())
