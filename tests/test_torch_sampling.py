"""The port's sampling against the JAX package: greedy tokens and the
policy distribution on the same logits.  Sampled tokens are never
compared across frameworks (the RNGs differ); within the port, the
per-row counter-based state is checked directly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import sampling as jsampling  # noqa: E402
from repro_torch.serving import sampling as tsampling  # noqa: E402
from tests.torch_helpers import configs  # noqa: E402

JCFG, TCFG = configs("float32")


def _logits(seed, B=4, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, TCFG.padded_vocab)) * scale).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_matches_jax_argmax(seed):
    lg = _logits(seed)
    tj, _ = jsampling.sample(jnp.asarray(lg), None, JCFG)
    tt, rng = tsampling.sample(torch.from_numpy(lg), tsampling.rng_state(
        range(4)), TCFG)
    assert np.array_equal(np.asarray(tj), tt.numpy())
    assert tt.dtype == torch.int32
    # per-row greedy (temperature 0 in a tensor) takes the same tokens
    zeros = torch.zeros(4)
    tt2, rng2 = tsampling.sample(torch.from_numpy(lg), rng, TCFG,
                                 temperature=zeros, top_k=torch.zeros(
                                     4, dtype=torch.int32))
    assert torch.equal(tt, tt2) and torch.equal(rng, rng2)


def test_policy_probs_match_jax_mixed_rows():
    lg = _logits(3)
    temp = np.asarray([0.0, 0.7, 1.3, 0.5], np.float32)
    topk = np.asarray([0, 16, 0, 1], np.int32)
    pj = jsampling.policy_probs(jnp.asarray(lg), JCFG,
                                temperature=jnp.asarray(temp),
                                top_k=jnp.asarray(topk))
    pt = tsampling.policy_probs(torch.from_numpy(lg), TCFG,
                                temperature=torch.from_numpy(temp),
                                top_k=torch.from_numpy(topk))
    assert float(np.abs(np.asarray(pj) - pt.numpy()).max()) < 1e-6
    assert float(pt[0].max()) == 1.0                   # greedy: one-hot
    assert int((pt[1] > 0).sum()) == 16                # top-k support


def test_greedy_rows_keep_rng_state_sampled_rows_advance():
    lg = torch.from_numpy(_logits(4))
    rng = tsampling.rng_state([10, 11, 12, 13])
    temp = torch.tensor([0.0, 0.8, 0.0, 1.0])
    topk = torch.tensor([0, 16, 0, 0], dtype=torch.int32)
    toks, rng2 = tsampling.sample(lg, rng, TCFG, temperature=temp,
                                  top_k=topk)
    assert torch.equal(rng2[:, 0], rng[:, 0])
    assert rng2[:, 1].tolist() == [0, 1, 0, 1]
    assert torch.equal(rng, tsampling.rng_state([10, 11, 12, 13]))
    greedy = torch.argmax(lg[:, :TCFG.vocab_size], -1)
    assert toks[0] == greedy[0] and toks[2] == greedy[2]
    # the sampled row stays inside its top-16 (of the tempered logits)
    top16 = torch.topk(lg[1, :TCFG.vocab_size], 16).indices
    assert int(toks[1]) in top16.tolist()
    # same state, same draws: counter-based, so replayable
    toks_again, _ = tsampling.sample(lg, rng, TCFG, temperature=temp,
                                     top_k=topk)
    assert torch.equal(toks, toks_again)
    # top_k = 1 collapses a sampled row onto the argmax
    one, _ = tsampling.sample(lg, rng, TCFG, temperature=1.0, top_k=1)
    assert torch.equal(one, greedy.to(torch.int32))


def test_sampled_frequencies_follow_policy_probs():
    """Draws from many counters follow ``policy_probs`` (the port's noise
    is Gumbel-max, as jax.random.categorical)."""
    V = TCFG.padded_vocab
    lg = torch.full((1, V), -1e4)
    lg[0, :4] = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    p = tsampling.policy_probs(lg, TCFG, temperature=1.0, top_k=0)[0, :4]
    rng = tsampling.rng_state([5])
    counts = np.zeros(4)
    for _ in range(2000):
        t, rng = tsampling.sample(lg, rng, TCFG, temperature=1.0, top_k=0)
        counts[int(t)] += 1
    assert np.abs(counts / 2000 - p.numpy()).max() < 0.04
    assert int(rng[0, 1]) == 2000

