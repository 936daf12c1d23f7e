"""Speculative tier hand-off across the fleet: draft on edge, verify on
cloud, per request.

The scenario: a short-context edge box sits next to the user; an
attested long-context cloud pod is the quality tier.  Each greedy
request prefills on the edge, its slot ships ONCE over the attested
wire (cache rows re-laid-out for the cloud's larger max_len), then the
edge free-runs gamma-token drafts that the cloud teacher-force verifies
-- committed output is bit-exactly what the cloud alone would produce,
while the cloud only spends verify bursts on it.  Confidential traffic
with no attested verify tier falls back to local-only drafting.

    PYTHONPATH=src python -m repro_torch.examples.speculative_fleet \
        [--device cpu] [--full]

The drafter samples from the port's RNG at T 0.8 and 1.5, so those
acceptance figures differ from the JAX example's; at T 0 every figure is
the greedy one.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.attestation import TrustAuthority
from repro_torch.core.daemon import CLOUD, EDGE, DeviceProfile
from repro_torch.core.validation import MarkerValidator
from repro_torch.examples import FULL_HELP, check, llama, parser
from repro_torch.fleet import EngineHandle, FleetController, RequestSpec
from repro_torch.serving.engine import Engine, Request

EDGE_LEN, CLOUD_LEN = 96, 256

# an unattested verify tier: the JAX example's constants
UNATTESTED_CLOUD = DeviceProfile("cloudX", peak_flops=197e12, hbm_bw=819e9,
                                 chips=8, attested=False)


def drain(engine, reqs):
    """Engine-level batch serve via the non-deprecated add/step loop."""
    pending, outs = list(reqs), {}
    while pending or engine.requests:
        while pending and engine.add_request(pending[0]):
            outs[pending[0].rid] = pending[0].output
            pending.pop(0)
        if engine.requests:
            engine.step()
    return outs


def run(cfg, params, *, device, edge=EDGE, cloud=CLOUD,
        unattested=UNATTESTED_CLOUD, edge_len=EDGE_LEN, cloud_len=CLOUD_LEN,
        temperatures=(0.0, 0.8, 1.5), gamma=4, top_k=16, n_prompts=6,
        max_new=16) -> dict:
    def handles():
        return [
            EngineHandle("edge", Engine(cfg, params, slots=4,
                                        max_len=edge_len, seed=0,
                                        device=device), edge),
            EngineHandle("cloud", Engine(cfg, params, slots=4,
                                         max_len=cloud_len, seed=1,
                                         device=device), cloud),
        ]

    rng = np.random.default_rng(0)
    prompts = [rng.integers(60, cfg.vocab_size, 8) for _ in range(n_prompts)]
    got = {"tiers": {}}

    print("== speculative tier: acceptance vs drafter temperature ==")
    for temp in temperatures:
        fleet = FleetController(
            handles(), authority=TrustAuthority(),
            spec_tiers={"edge": "cloud"},
            spec_options={"gamma": gamma, "drafter_temperature": temp,
                          "drafter_top_k": top_k})
        reqs = [RequestSpec(rid=f"r{i}", prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        outs = fleet.run(reqs)
        st = fleet.spec_controllers["edge"].stats
        got["tiers"][temp] = dict(
            acceptance=st.acceptance_rate, accepted=st.accepted,
            proposed=st.proposed, rounds=st.rounds,
            corrections=st.corrections,
            handoff_bytes=st.handoff_bytes / st.handoffs,
            handoff_ms=st.handoff_wire_s * 1e3 / st.handoffs)
        print(f"  drafter T={temp:3.1f}: acceptance "
              f"{st.acceptance_rate:5.1%} ({st.accepted}/{st.proposed}), "
              f"{st.rounds} rounds, {st.corrections} corrections, "
              f"hand-off {st.handoff_bytes / st.handoffs:.0f} B/slot "
              f"@ {st.handoff_wire_s * 1e3 / st.handoffs:.1f} ms wire")
        if temp == 0.0:
            baseline = outs

    # committed output is the cloud's own greedy output, bit-exactly:
    pure = Engine(cfg, params, slots=4, max_len=cloud_len, seed=7,
                  device=device)
    refs = drain(pure, [Request(f"r{i}", p, max_new_tokens=max_new)
                        for i, p in enumerate(prompts)])
    check(all(baseline[r] == refs[r] for r in refs),
          "spec output != pure cloud-engine output")
    got["outputs"] = baseline
    print("  spec output == pure cloud-engine output: True "
          f"(edge max_len {edge_len} != cloud max_len {cloud_len})")

    print("\n== sensitivity gate: unattested verify tier ==")
    hs = handles()
    hs[1] = EngineHandle("cloud", hs[1].engine, unattested)
    fleet = FleetController(hs, authority=TrustAuthority(),
                            spec_tiers={"edge": "cloud"})
    conf = RequestSpec(rid="conf", prompt=prompts[0], max_new_tokens=12,
                       sensitivity="confidential")
    pub = RequestSpec(rid="pub", prompt=prompts[1], max_new_tokens=12)
    outs = fleet.run([conf, pub])
    st = fleet.spec_controllers["edge"].stats
    got.update(local_fallbacks=st.local_fallbacks,
               conf_placements=fleet.placements["conf"])
    print(f"  confidential request stayed local "
          f"(local_fallbacks={st.local_fallbacks}, "
          f"placements={fleet.placements['conf']})")
    check(fleet.placements["conf"] == ["edge"],
          f"confidential request placed on {fleet.placements['conf']}")
    check(len(outs["conf"]) == 12,
          f"confidential request gave {len(outs['conf'])} tokens of 12")

    print("\n== validators run on the committed stream ==")
    fleet = FleetController(
        handles(), authority=TrustAuthority(),
        spec_tiers={"edge": "cloud"},
        spec_options={"validators": [
            MarkerValidator("harmful_content", "harmful", range(10, 20))]})
    # a prompt soaked in harmful-marker ids makes the model emit them
    bad = RequestSpec(rid="bad",
                      prompt=np.asarray([12, 14, 16, 18, 12, 14, 16, 18]),
                      max_new_tokens=max_new)
    outs = fleet.run([bad])
    st = fleet.spec_controllers["edge"].stats
    got.update(interventions=st.interventions, halted=len(outs["bad"]))
    print(f"  interventions={st.interventions}, "
          f"halted output length={len(outs['bad'])} (of {max_new})")
    return got


def main(argv=None) -> int:
    args = parser("speculative_fleet", __doc__,
                  full_help=FULL_HELP).parse_args(argv)
    cfg, params, device = llama(args)
    run(cfg, params, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
