"""Scenario 3 (collaborative medical diagnosis): confidential placement
+ attested migration + parallel validation that intervenes mid-stream.

    PYTHONPATH=src python -m repro_torch.examples.validated_medical_agent \
        [--device cpu]

The daemon's remote profile is the port's ``CLOUD``, one H100, so the
hospital policy's speedup is the port's own figure (the JAX example's
``CLOUD`` is a TPU slice).  The tokens are sampled from the port's RNG,
so the position where a validator intervenes differs from the JAX
example's; it is held at or before the planted marker.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs import get
from repro_torch.core.daemon import CLOUD, EDGE, PrivacyAwareDaemon
from repro_torch.core.validation import MEDICAL, ValidationFramework
from repro_torch.examples import FULL_HELP, check, llama, parser
from repro_torch.serving.engine import Engine, Request


def run(cfg, params, *, device, local=EDGE, remote=CLOUD, max_len=96,
        seed=4, prompt_len=8, max_new=32, temperature=0.8, top_k=16,
        stride=2, plant_at=9) -> dict:
    got = {}
    # 1. the daemon pins patient data to hospital infrastructure
    job = dict(sensitivity="confidential", cfg=get("llama-1.5b"),
               prefill_tokens=200_000, decode_tokens=20_000,
               workspace_bytes=10 ** 8)
    daemon = PrivacyAwareDaemon(local, remote)   # confidential stays
    dec = daemon.decide(**job)
    got.update(default=dec.target, reason=dec.reason)
    print(f"placement for confidential case: {dec.target} ({dec.reason})")

    hospital = PrivacyAwareDaemon(local, remote,
                                  max_remote_sensitivity="confidential")
    dec = hospital.decide(**job)
    got.update(hospital=dec.target, speedup=dec.speedup)
    print(f"with hospital private-cloud policy: {dec.target} "
          f"(speedup {dec.speedup:.1f}x)")

    # 2. diagnosis generation with in-stream validation
    engine = Engine(cfg, params, slots=1, max_len=max_len, seed=seed,
                    device=device)
    req = Request("dx-patient-7", np.arange(prompt_len),
                  max_new_tokens=max_new, temperature=temperature,
                  top_k=top_k)
    engine.add_request(req)
    vf = ValidationFramework(stride=stride)

    emitted = []

    def emit():
        if not engine.requests:
            return None
        toks = engine.step()
        t = toks.get("dx-patient-7")
        if t is None:
            return None
        emitted.append(t)
        # plant a synthetic medical-error marker to show intervention
        if len(emitted) == plant_at:
            return MEDICAL.start + 2
        return t

    tokens, report = vf.validate_stream(emit)
    got.update(intervened=report.intervened, kept=len(tokens),
               mode=report.mode, wall_s=report.wall_s)
    if report.intervened:
        bad = [v for v in report.verdicts if not v.ok][0]
        got.update(kind=bad.kind, position=bad.position)
        print(f"\nvalidator '{bad.kind}' INTERVENED at position "
              f"{bad.position}: suggestion blocked before reaching "
              f"the physician ({len(tokens)} safe tokens kept)")
    check(report.intervened and report.halt_position < plant_at,
          f"no validator intervened at or before the planted marker "
          f"(position {plant_at - 1}): {report.verdicts}")
    print(f"validation mode: {report.mode}, wall {report.wall_s*1000:.0f}ms"
          f" (parallel with generation -- paper: +3-5% vs +18% serial)")
    return got


def main(argv=None) -> int:
    args = parser("validated_medical_agent", __doc__,
                  full_help=FULL_HELP).parse_args(argv)
    cfg, params, device = llama(args)
    run(cfg, params, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
