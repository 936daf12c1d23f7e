"""The port's replication manager and placement daemon on the CPU:
counterparts of the replication and daemon tests of
``tests/test_core_features.py`` and of scenarios 1 and 3 of
``tests/test_system.py``, the degraded-restore branch of ``failover``,
and parity with the JAX package: ``decide()``, ``step_time``,
``pick_tier()``, ``merge_on_reconnect()`` and the sync byte counts on
the same inputs, ``param_bytes`` / ``count_params`` /
``abstract_params``, the composed fabric conditions, and the engines'
profile hook and deprecated ``Engine.run``."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import daemon as jdaemon  # noqa: E402
from repro.core.migration import _pack_workspace as jpack_ws  # noqa: E402
from repro.models import init as jinit  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.attestation import (Attester, TrustAuthority,  # noqa: E402
                                          capabilities, measure_config)
from repro_torch.core.channel import (AttestedSession, Channel,  # noqa: E402
                                      Fabric, NetworkCondition)
from repro_torch.core.daemon import (CLOUD, EDGE, DeviceProfile,  # noqa: E402
                                     PrivacyAwareDaemon)
from repro_torch.core.migration import Migrator, _pack_workspace  # noqa: E402
from repro_torch.core.replication import (ReplicaTier,  # noqa: E402
                                          ReplicationManager)
from repro_torch.core.validation import HARMFUL, ValidationFramework  # noqa: E402
from repro_torch.core.workspace import AgentWorkspace, VectorClock  # noqa: E402
from repro_torch.models import init as tinit  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.paged import PagedEngine  # noqa: E402
from tests.torch_helpers import fleet_side, fleet_weights  # noqa: E402

CFG = make_tiny(get("llama-1.5b"))
GID = measure_config(CFG)
AUTH = TrustAuthority()


def _params():
    return fleet_weights()["torch"]["full"][1]


def _engine(seed=0, slots=2, max_len=64):
    return Engine(CFG, _params(), slots=slots, max_len=max_len, seed=seed,
                  device="cpu")


def _tiers(max_len=64):
    mk = lambda s: _engine(s, max_len=max_len)  # noqa: E731
    return [
        ReplicaTier("cloud", mk(0), quality=1.0, functionality=1.0),
        ReplicaTier("edge", mk(1), quality=0.8, functionality=0.85),
        ReplicaTier("device", mk(2), quality=0.5, functionality=0.8),
    ]


# -- replication (tests/test_core_features.py) --------------------------------

def test_failover_on_disconnect_picks_edge_then_device():
    mgr = ReplicationManager(_tiers())
    eng = mgr.tiers["cloud"].engine
    req = Request("r0", np.arange(6), max_new_tokens=16)
    eng.add_request(req)
    eng.step()
    mgr.sync(AgentWorkspace.from_engine(eng, GID))

    mgr.tiers["cloud"].cond.up = False
    tier, latency = mgr.failover("cloud disconnect")
    assert tier.name == "edge"
    assert latency < 0.2  # the paper's 200ms failover budget
    assert set(mgr.last_failover_stages) == {"unpack", "place", "attach"}
    assert sum(mgr.last_failover_stages.values()) <= latency

    mgr.tiers["edge"].cond.up = False
    tier, _ = mgr.failover("edge also down")
    assert tier.name == "device"  # total disconnection -> on-device


def test_bandwidth_starved_network_degrades_to_lightweight_tier():
    tiers = _tiers()
    for t in tiers:
        t.cond.bandwidth_bps = 5e5  # < 1 Mbps (paper §9.6 scenario)
    mgr = ReplicationManager(tiers)
    assert mgr.pick_tier().name == "device"


def test_incremental_sync_fraction():
    mgr = ReplicationManager(_tiers(max_len=512))
    eng = mgr.tiers["cloud"].engine
    req = Request("r0", np.arange(6), max_new_tokens=30)
    eng.add_request(req)
    eng.step()
    mgr.sync(AgentWorkspace.from_engine(eng, GID))
    eng.step()
    mgr.sync(AgentWorkspace.from_engine(eng, GID))
    assert mgr.last_delta_fraction < 0.5


def test_vector_clock_merge_on_reconnect():
    mgr = ReplicationManager(_tiers())
    a = AgentWorkspace(None, [{"rid": "r1", "output": [1]}], CFG.name,
                       GID, vclock=VectorClock({"edge": 3}))
    b = AgentWorkspace(None, [{"rid": "r2", "output": [2]}], CFG.name,
                       GID, vclock=VectorClock({"edge": 1, "cloud": 4}))
    merged = mgr.merge_on_reconnect(a, b)  # concurrent
    assert {r["rid"] for r in merged.requests} == {"r1", "r2"}
    assert merged.vclock.clocks == {"edge": 3, "cloud": 4}


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_corrupted_snapshot_takes_the_degraded_restore_branch(side):
    """A snapshot that does not restore leaves the target tier serving
    at 80% functionality (the bare ``except`` both packages keep)."""
    S = fleet_side(side)
    R = S.replication
    mk = lambda s: S.engine(seed=s, slots=3, max_len=64)  # noqa: E731
    mgr = R.ReplicationManager([R.ReplicaTier("cloud", mk(0), 1.0, 1.0),
                                R.ReplicaTier("edge", mk(1), 0.8, 0.85)])
    eng = mgr.tiers["cloud"].engine
    eng.add_request(S.Request("r0", np.arange(6), max_new_tokens=8))
    eng.step()
    mgr.sync(S.workspace.AgentWorkspace.from_engine(eng, "gid"))
    snap = mgr.tiers["edge"].snapshot
    mgr.tiers["edge"].snapshot = dataclasses.replace(
        snap, blob=snap.blob[:len(snap.blob) // 2])
    mgr.tiers["cloud"].cond.up = False
    tier, _ = mgr.failover("corrupted replica")
    assert tier.name == "edge"
    assert tier.functionality == pytest.approx(0.85 * 0.8)
    assert not tier.engine.requests          # nothing was attached


# -- daemon (tests/test_core_features.py) ------------------------------------

def test_daemon_policy_pins_confidential_local():
    d = PrivacyAwareDaemon()
    dec = d.decide(sensitivity="confidential", cfg=get("llama-1.5b"),
                   prefill_tokens=10 ** 5, decode_tokens=10 ** 4,
                   workspace_bytes=10 ** 8)
    assert dec.target == "local"
    assert "policy" in dec.reason


def test_daemon_amortization_rule():
    """Paper §9.4: migrate iff speedup >= 1.5x AND work >= 2x migration."""
    d = PrivacyAwareDaemon()
    cfg = get("llama-1.5b")
    big = d.decide(sensitivity="public", cfg=cfg, prefill_tokens=200_000,
                   decode_tokens=50_000, workspace_bytes=10 ** 8)
    assert big.target == "remote"
    assert big.speedup >= 1.5
    tiny = d.decide(sensitivity="public", cfg=cfg, prefill_tokens=16,
                    decode_tokens=4, workspace_bytes=10 ** 9)
    assert tiny.target == "local"


def test_daemon_unattested_remote_refused():
    d = PrivacyAwareDaemon(remote=dataclasses.replace(CLOUD,
                                                      attested=False))
    dec = d.decide(sensitivity="public", cfg=get("llama-1.5b"),
                   prefill_tokens=10 ** 6, decode_tokens=10 ** 5,
                   workspace_bytes=10 ** 7)
    assert dec.target == "local"
    assert "unattested" in dec.reason


def test_daemon_network_down_stays_local():
    d = PrivacyAwareDaemon(net=NetworkCondition(up=False))
    dec = d.decide(sensitivity="public", cfg=get("llama-1.5b"),
                   prefill_tokens=10 ** 6, decode_tokens=10 ** 5,
                   workspace_bytes=10 ** 7)
    assert dec.target == "local"


def test_port_cloud_is_one_h100():
    """The port's CLOUD is the card it runs on (data sheet: dense bf16
    tensor-core peak, HBM3 rate), so the daemon's decode roofline for
    llama-1.5b is its weight bytes over 3.35 TB/s."""
    assert (CLOUD.peak_flops, CLOUD.hbm_bw, CLOUD.chips) == \
        (989e12, 3.35e12, 1)
    assert (EDGE, dataclasses.asdict(EDGE)) == \
        (DeviceProfile(**dataclasses.asdict(jdaemon.EDGE)),
         dataclasses.asdict(jdaemon.EDGE))
    cfg = get("llama-1.5b")
    t = PrivacyAwareDaemon.step_time(cfg, CLOUD, decode_tokens=1)
    assert t == pytest.approx(tinit.param_bytes(cfg) / 3.35e12)


# -- the paper's scenarios (tests/test_system.py) -----------------------------

def test_scenario1_travel_blogger_offline_failover():
    """Privacy-preserving assistant with unreliable connectivity:
    cloud serves while up; on disconnect the system fails over to a
    local replica and work continues; on reconnect state merges."""
    mgr = ReplicationManager([
        ReplicaTier("cloud", _engine(0), 1.0, 1.0),
        ReplicaTier("edge", _engine(1), 0.8, 0.85),
        ReplicaTier("device", _engine(2), 0.5, 0.8),
    ])
    cloud = mgr.tiers["cloud"].engine
    req = Request("draft-post", np.arange(6), max_new_tokens=24,
                  sensitivity="personal")
    cloud.add_request(req)
    for _ in range(4):
        cloud.step()
        mgr.sync(AgentWorkspace.from_engine(cloud, GID))
    tokens_before = len(req.output)

    mgr.tiers["cloud"].cond.up = False           # remote mountains
    tier, latency = mgr.failover("disconnect")
    assert tier.name == "edge" and latency < 0.2
    edge = tier.engine
    assert edge.requests, "in-flight request survived failover"
    cont = [r for r in edge.requests.values()][0]
    assert cont.output[:tokens_before] == req.output[:tokens_before]
    for _ in range(3):
        edge.step()
    assert len(cont.output) > tokens_before       # work continued offline


def test_scenario3_medical_agent_migrates_only_attested():
    """Patient data (confidential) stays local; an attested private-
    cloud enclave may receive it; outputs are validated in-stream."""
    daemon = PrivacyAwareDaemon(max_remote_sensitivity="confidential")
    dec = daemon.decide(sensitivity="confidential", cfg=get("llama-1.5b"),
                        prefill_tokens=500_000, decode_tokens=100_000,
                        workspace_bytes=10 ** 8)
    assert dec.target == "remote"   # allowed: hospital private cloud

    eng = _engine(seed=7)
    req = Request("dx-1", np.arange(6), max_new_tokens=10,
                  sensitivity="confidential")
    eng.add_request(req)
    eng.step()
    ws = AgentWorkspace.from_engine(eng, GID)
    a = Attester("hospital-edge", AUTH, GID, capabilities(CFG))
    b = Attester("hospital-cloud", AUTH, GID, capabilities(CFG))
    sess = AttestedSession(a, b, Channel(), {GID})
    eng2, rep = Migrator().migrate(ws, sess, _engine(seed=8))
    assert eng2.requests
    vf = ValidationFramework(stride=1)
    stream = iter([60, 61, HARMFUL.start + 3, 63, None])
    toks, vrep = vf.validate_stream(lambda: next(stream))
    assert vrep.intervened and HARMFUL.start + 3 not in toks


# -- parity with the JAX package ----------------------------------------------

def _port_profile(jprofile):
    return DeviceProfile(**dataclasses.asdict(jprofile))


@pytest.mark.parametrize("sensitivity", ["public", "personal",
                                         "confidential"])
@pytest.mark.parametrize("work", [(16, 4, 10 ** 9),
                                  (200_000, 50_000, 10 ** 8),
                                  (10 ** 6, 10 ** 5, 10 ** 7)])
def test_decide_matches_jax_on_the_same_profiles(sensitivity, work):
    prefill, decode, ws = work
    for remote in (jdaemon.CLOUD, dataclasses.replace(jdaemon.CLOUD,
                                                      attested=False)):
        for up in (True, False):
            jd = jdaemon.PrivacyAwareDaemon(
                remote=remote, net=jchannel.NetworkCondition(up=up))
            td = PrivacyAwareDaemon(
                remote=_port_profile(remote), net=NetworkCondition(up=up))
            kw = dict(sensitivity=sensitivity, prefill_tokens=prefill,
                      decode_tokens=decode, workspace_bytes=ws)
            jdec = jd.decide(cfg=jget("llama-1.5b"), **kw)
            tdec = td.decide(cfg=get("llama-1.5b"), **kw)
            assert dataclasses.asdict(tdec) == dataclasses.asdict(jdec)


@pytest.mark.parametrize("name", ["llama-1.5b", "rwkv6-7b"])
def test_param_counts_match_jax(name):
    jcfg, tcfg = jget(name), get(name)
    assert tinit.param_bytes(tcfg) == jinit.param_bytes(jcfg)
    assert tinit.count_params(tcfg) == jinit.count_params(jcfg)
    jabs = jax.tree_util.tree_leaves_with_path(jinit.abstract_params(jcfg))
    from repro_torch.core.tree import leaves_with_path
    tabs = leaves_with_path(tinit.abstract_params(tcfg))
    assert [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jabs] == \
        [(p, a.shape, str(a.dtype).removeprefix("torch."))
         for p, a in tabs]
    assert all(a.device.type == "meta" for _, a in tabs)


def _replicate(S):
    """A three-tier manager of one package: four synced steps, a
    bandwidth squeeze, a failover, and a concurrent merge."""
    R, W = S.replication, S.workspace
    mk = lambda s: S.engine(seed=s, slots=3, max_len=64)  # noqa: E731
    mgr = R.ReplicationManager([R.ReplicaTier("cloud", mk(0), 1.0, 1.0),
                                R.ReplicaTier("edge", mk(1), 0.8, 0.85),
                                R.ReplicaTier("device", mk(2), 0.5, 0.8)])
    eng = mgr.tiers["cloud"].engine
    eng.add_request(S.Request("r0", np.arange(6), max_new_tokens=16))
    syncs, fracs, full = [], [], None
    for _ in range(4):
        eng.step()
        ws = W.AgentWorkspace.from_engine(eng, "gid")
        full = full or ws
        syncs.append(mgr.sync(ws))
        fracs.append(mgr.last_delta_fraction)
    picks = []
    for bw in (1e9, 5e5):
        for t in mgr.tiers.values():
            t.cond.bandwidth_bps = bw
        picks.append(mgr.pick_tier().name)
    mgr.tiers["cloud"].cond.up = False
    tier, _ = mgr.failover("disconnect")
    out = [r.output for r in tier.engine.requests.values()]
    a = W.AgentWorkspace(None, [{"rid": "x", "output": [1]},
                                {"rid": "l", "output": [7]}], "c", "gid",
                         vclock=W.VectorClock({"edge": 3}))
    b = W.AgentWorkspace(None, [{"rid": "x", "output": [2]}], "c", "gid",
                         vclock=W.VectorClock({"edge": 1, "cloud": 4}))
    merges = [mgr.merge_on_reconnect(a, b, local_tier=lt, remote_tier=rt)
              for lt, rt in (("edge", "cloud"), ("cloud", "edge"),
                             (None, None))]
    return dict(syncs=syncs, fracs=fracs, picks=picks, tier=tier.name,
                out=out, events=[(e.src, e.dst, e.quality, e.reason)
                                 for e in mgr.events],
                merges=[(m.requests, m.vclock.clocks) for m in merges],
                full=full)


def test_replication_matches_jax():
    """The same workspace stream through both managers: equal delta
    fractions, tier picks, failover events, restored outputs and merges.
    Sync bytes differ by one constant: the packed RNG leaf, which each
    framework writes in its own form (ROADMAP, wire compatibility)."""
    j, t = (_replicate(fleet_side(side)) for side in ("jax", "torch"))
    assert t["fracs"] == j["fracs"] and t["fracs"][0] == 1.0
    assert t["picks"] == j["picks"] == ["cloud", "device"]
    assert (t["tier"], t["out"], t["events"]) == \
        (j["tier"], j["out"], j["events"])
    assert t["merges"] == j["merges"]
    rng_delta = len(_pack_workspace(t["full"])) - len(jpack_ws(j["full"]))
    assert 0 < rng_delta < 64
    for ts, js in zip(t["syncs"], j["syncs"]):
        assert ts.keys() == js.keys()
        assert all(ts[k] - js[k] == rng_delta for k in ts)


def _fabric_readings(fabric_cls, cond):
    fab = fabric_cls()
    fab.set_endpoint("a", cond(latency_s=0.01, bandwidth_bps=5e8, loss=0.1))
    fab.set_link("a", "b", cond(latency_s=0.02, bandwidth_bps=1e9,
                                loss=0.2))
    p = fab.path("a", "b")
    got = (p.latency_s, p.bandwidth_bps, p.loss, p.up,
           p.transfer_time(10 ** 6),
           fab.link("a", "b").cond.transfer_time(10 ** 6))
    fab.set_endpoint("a", cond(up=False))
    return got + (fab.link("a", "b").cond.up,
                  fab.pair_link("a", "b").cond.up)


def test_fabric_paths_compose_as_jax():
    j = _fabric_readings(jchannel.Fabric, jchannel.NetworkCondition)
    t = _fabric_readings(Fabric, NetworkCondition)
    assert t == j
    assert t[-2:] == (False, True)      # a pinned circuit ignores uplinks


# -- the engine surface the fleet needs ---------------------------------------

def test_paged_profile_hook_fires_once_per_program_key():
    calls = []
    eng = PagedEngine(CFG, _params(), page_size=8, rows=1, max_len=48,
                      seed=3, device="cpu",
                      profile_hook=lambda key, dt, **m: calls.append(
                          (key, dt, m.get("cache_hit"))))
    for rid in ("p", "q"):
        req = Request(rid, np.arange(5), max_new_tokens=3)
        eng.add_request(req)
        while not req.done:
            eng.step()
    assert [k for k, _, _ in calls] == ["prefill[plen=5]", "decode"]
    assert all(dt > 0 for _, dt, _ in calls)
    # a second engine of the geometry reports its first runs as hits
    calls.clear()
    twin = PagedEngine(CFG, _params(), page_size=8, rows=1, max_len=48,
                       seed=4, device="cpu",
                       profile_hook=lambda key, dt, **m: calls.append(
                           (key, dt, m.get("cache_hit"))))
    req = Request("r", np.arange(5), max_new_tokens=2)
    twin.add_request(req)
    twin.step()
    assert [(k, hit) for k, _, hit in calls] == \
        [("prefill[plen=5]", True), ("decode", True)]


def test_engine_run_is_deprecated_and_serves_to_completion():
    eng = _engine(seed=4, slots=3)
    reqs = [Request(f"r{i}", np.arange(3 + i), max_new_tokens=4)
            for i in range(4)]
    with pytest.warns(DeprecationWarning, match="Engine.run"):
        outs = eng.run(reqs)
    assert {k: len(v) for k, v in outs.items()} == \
        {f"r{i}": 4 for i in range(4)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solo = _engine(seed=4, slots=3)._run(
            [Request("r0", np.arange(3), max_new_tokens=4)])
    assert solo["r0"] == outs["r0"]
