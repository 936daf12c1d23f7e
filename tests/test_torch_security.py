"""The port's attestation, channel and sealed migration against the
paper's §9.2 validation matrix (counterparts of ``tests/test_security.py``:
confidentiality, integrity, freshness, authenticity, capability gating,
transitive trust, incremental Merkle attestation), and its measurements
against the JAX package's: the same configuration and the same weights
must give the same ``global_id`` inputs in both."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.core import attestation as jatt  # noqa: E402
from repro_torch.configs import MoESpec  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core import crypto  # noqa: E402
from repro_torch.core.attestation import (  # noqa: E402
    AttestationError, Attester, MerkleTree, TrustAuthority, capabilities,
    covers, measure_config, platform_of, required_capabilities,
    semantic_attest)
from repro_torch.core.channel import (AttestedSession, Channel,  # noqa: E402
                                      SimClock, transitive_chain)
from repro_torch.core.migration import Migrator  # noqa: E402
from repro_torch.core.workspace import AgentWorkspace  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from tests.torch_helpers import bridged_params, configs  # noqa: E402

CFG = make_tiny(get("llama-1.5b"))
AUTH = TrustAuthority()
GID = measure_config(CFG)
CAPS = capabilities(CFG, platform="gpu")
_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        _PARAMS["p"] = init_params(CFG, torch.Generator().manual_seed(0),
                                   device="cpu")
    return _PARAMS["p"]


def mk_attester(name, gid=GID, caps=CAPS, clock=time.time):
    return Attester(name, AUTH, gid, caps, clock=clock)


def mk_engine(seed=0):
    return Engine(CFG, _params(), slots=2, max_len=64, seed=seed,
                  device="cpu")


def mk_workspace(engine):
    req = Request("r0", np.arange(6), max_new_tokens=10)
    engine.add_request(req)
    for _ in range(3):
        engine.step()
    return AgentWorkspace.from_engine(engine, GID)


# -- confidentiality ---------------------------------------------------------

def test_wire_bytes_are_ciphertext():
    """The channel tap (network adversary) sees neither plaintext KV
    bytes nor token ids, and the ciphertext does not compress."""
    import zlib
    eng = mk_engine()
    ws = mk_workspace(eng)
    captured = []
    ch = Channel(taps=[lambda b: (captured.append(b), b)[1]])
    s = AttestedSession(mk_attester("a"), mk_attester("b"), ch, {GID})
    Migrator().migrate(ws, s, mk_engine(seed=9))
    blob = max(captured, key=len)            # the state transfer
    assert ws.engine_state.tokens.numpy().tobytes()[:64] not in blob
    k = ws.engine_state.caches[0][0]["attn"]["k"]
    assert k.view(torch.int16).numpy().tobytes()[:64] not in blob
    assert len(zlib.compress(blob, 9)) > 0.9 * len(blob)


# -- integrity ----------------------------------------------------------------

def test_tampered_transfer_is_refused():
    """Bit-flip on the wire => HMAC failure => restore refused, and the
    target engine's state is left as it was."""
    ws = mk_workspace(mk_engine())

    def flip(b):
        i = len(b) // 2
        return b[:i] + bytes([b[i] ^ 0x40]) + b[i + 1:]

    target = mk_engine(seed=9)
    before = target.state
    s = AttestedSession(mk_attester("a"), mk_attester("b"),
                        Channel(taps=[flip]), {GID})
    with pytest.raises(crypto.IntegrityError):
        Migrator().migrate(ws, s, target)
    assert target.state is before and not target.requests


def test_aad_binds_state_to_measurement():
    key = b"k" * 32
    sealed = crypto.seal(key, b"payload", aad=b"model-A")
    with pytest.raises(crypto.IntegrityError):
        crypto.open_(key, sealed, aad=b"model-B")


# -- authenticity / whitelist -------------------------------------------------

def test_unwhitelisted_measurement_refused():
    rogue = mk_attester("evil-host",
                        gid=measure_config(CFG.replace(name="evil")))
    with pytest.raises(AttestationError, match="not whitelisted"):
        AttestedSession(mk_attester("a"), rogue, Channel(), {GID})


def test_forged_signature_refused():
    forger = Attester("b", TrustAuthority(seed=b"attacker-root"), GID, CAPS)
    with pytest.raises(AttestationError, match="bad signature"):
        AttestedSession(mk_attester("a"), forger, Channel(), {GID})


# -- freshness ----------------------------------------------------------------

def test_stale_quote_refused():
    clock = SimClock(t0=1000.0)
    a = mk_attester("a", clock=clock)
    b = mk_attester("b", clock=clock)
    q = a.quote("nonce1")
    clock.advance(400.0)  # > 300s freshness window
    with pytest.raises(AttestationError, match="stale"):
        b.verify("a", q, nonce="nonce1", whitelist={GID})


def test_counter_replay_refused():
    a = mk_attester("a")
    b = mk_attester("b")
    q = a.quote("n1")
    b.verify("a", q, nonce="n1", whitelist={GID})
    with pytest.raises(AttestationError, match="replay"):
        b.verify("a", q, nonce="n1", whitelist={GID})


# -- capability gating (entry_id, paper §5) -----------------------------------

def test_capability_gap_refuses_migration():
    """A MoE workload must not migrate to an enclave without MOE_EP.  The
    port has no MoE family yet, so the tiny llama carries a MoE spec;
    its requirement set equals the JAX one of the tiny granite MoE."""
    moe_cfg = CFG.replace(moe=MoESpec(num_experts=4, top_k=2, d_expert=32))
    need = required_capabilities(moe_cfg, kv_len=1024)
    assert need == jatt.required_capabilities(
        jtiny(jget("granite-moe-1b-a400m")), kv_len=1024)
    weak_caps = frozenset({"WASI_CORE", "MAX_KV_LEN:2048"})
    with pytest.raises(AttestationError, match="capability gap"):
        AttestedSession(mk_attester("src"), mk_attester("dst",
                                                        caps=weak_caps),
                        Channel(), {GID}, need=need)


def test_kv_len_capability():
    assert covers(frozenset({"MAX_KV_LEN:32768"}),
                  frozenset({"KV_LEN:32768"}))
    assert not covers(frozenset({"MAX_KV_LEN:32768"}),
                      frozenset({"KV_LEN:524288"}))


# -- transitive trust ---------------------------------------------------------

def test_multihop_chain_poisoned_by_bad_hop():
    good = [mk_attester(f"hop{i}") for i in range(3)]
    assert len(transitive_chain(good, Channel(), {GID})) == 4
    bad = [mk_attester("hop0"),
           mk_attester("hopX", gid=measure_config(CFG.replace(name="x"))),
           mk_attester("hop2")]
    with pytest.raises(AttestationError):
        transitive_chain(bad, Channel(), {GID})


# -- merkle incremental attestation (paper §6) --------------------------------

def test_merkle_incremental_update():
    params = init_params(CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    t = MerkleTree.build(params)
    root0 = t.root
    params["final_norm"]["scale"] = params["final_norm"]["scale"] * 1.5
    root1, n = t.update({"final_norm": params["final_norm"]})
    assert n == 1
    assert root1 != root0
    params["final_norm"]["scale"] = params["final_norm"]["scale"] / 1.5
    root2, _ = t.update({"final_norm": params["final_norm"]})
    assert root2 == root0


# -- the same measurements as the JAX package ---------------------------------

@pytest.mark.parametrize("name,tiny", [("llama-1.5b", False),
                                       ("llama-1.5b", True),
                                       ("rwkv6-7b", False),
                                       ("rwkv6-7b", True)])
def test_measure_config_matches_jax(name, tiny):
    ours, theirs = get(name), jget(name)
    if tiny:
        ours, theirs = make_tiny(ours), jtiny(theirs)
    assert measure_config(ours) == jatt.measure_config(theirs)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_merkle_root_matches_jax_on_bridged_weights(dtype):
    jcfg, _ = configs(dtype)
    jp, tp = bridged_params(jcfg, seed=3)
    ours, theirs = MerkleTree.build(tp), jatt.MerkleTree.build(jp)
    assert ours.leaves == theirs.leaves
    assert ours.root == theirs.root


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_capabilities_and_quotes_match_jax(platform):
    jcfg = jtiny(jget("llama-1.5b"))
    caps = capabilities(CFG, platform=platform)
    assert caps == jatt.capabilities(jcfg, platform=platform)
    clock = SimClock(t0=50.0)
    ours = Attester("edge", TrustAuthority(), GID, caps, clock=clock)
    theirs = jatt.Attester("edge", jatt.TrustAuthority(), GID, caps,
                           clock=clock)
    qa, qb = ours.quote("n"), theirs.quote("n")
    assert qa.payload() == qb.payload() and qa.signature == qb.signature


def test_platform_comes_from_a_torch_device():
    assert platform_of("cuda") == "gpu"
    assert platform_of(torch.device("cpu")) == "cpu"
    assert platform_of() == ("gpu" if torch.cuda.is_available() else "cpu")
    assert "WASI_NN" in capabilities(CFG, platform=platform_of("cuda"))
    assert "WASI_NN_CPU" in capabilities(CFG, platform=platform_of("cpu"))
    assert capabilities(CFG) == capabilities(CFG, platform=platform_of())


def test_semantic_attest_takes_tensors_and_arrays():
    x = torch.linspace(-1, 1, 16)
    good = semantic_attest(lambda a: a * 2, lambda a: a.numpy() * 2, [x])
    bad = semantic_attest(lambda a: a * 2 + 1, lambda a: a * 2, [x],
                          eps=0.5)
    assert good["ok"] and good["max_err"] == 0.0
    assert not bad["ok"] and bad["max_err"] == pytest.approx(1.0)
    assert good["output_digest"] == jatt.semantic_attest(
        lambda a: a * 2, lambda a: np.asarray(a) * 2,
        [np.asarray(x.numpy())])["output_digest"]


def test_jax_and_port_attesters_hold_a_session():
    """A port enclave and a JAX enclave of the same authority attest each
    other and derive the same session key."""
    a = mk_attester("edge")
    b = jatt.Attester("cloud", jatt.TrustAuthority(), GID, CAPS)
    s = AttestedSession(a, b, Channel(), {GID})
    assert s.key_a == s.key_b
    assert s.transfer(b"state", aad=GID.encode()) == b"state"
