"""``repro_torch.examples.train_100m`` against the JAX package's
``examples/train_100m.py``: the port's configs equal the example's, the
first five losses on ``CFG_2M`` equal JAX ``make_train_step``'s on the
same weights (``jax.random.key(0)``, bridged) and the same ``Pipeline``
batches, in float32 by the rule of ``tests/test_torch_train_parity.py``
(1e-5 relative), with the example's optimizer (lr 3e-3, 10 warm-up
steps, the schedule over the run's steps); and a run interrupted after
its first checkpoint resumes to the uninterrupted run's parameters and
AdamW moments bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.models.init import params_from_numpy  # noqa: E402
from tests.torch_helpers import captured, jax_example, to_numpy  # noqa: E402

LOSS_REL = 1e-5
STEPS, BATCH, SEQ = 5, 8, 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module, as in
    ``tests/test_torch_train_parity.py``: the tiny models' ops are too
    small to split, and under the suite's six workers on a shared CPU
    the split costs many times the module's time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_train():
    return jax_example("train_100m")


@pytest.mark.parametrize("name", ["CFG_2M", "CFG_100M"])
def test_configs_equal_the_examples(jax_train, name):
    """The port's copies of the example's configs: every field equal,
    the parameter counts too."""
    from repro.models.init import count_params as jcount
    from repro_torch.models.init import count_params
    j, t = getattr(jax_train, name), getattr(train_100m, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert count_params(t) == jcount(j)


def _to_jax(tree, like):
    """A port state tree as a JAX tree shaped like ``like``, leaf by key
    path (float32 and int32 leaves here)."""
    got = {k: v.detach().cpu().numpy() for k, v in leaves_with_path(tree)}
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(got[jax.tree_util.keystr(p)], a.dtype),
        like)


def test_first_losses_equal_jax(jax_train, tmp_path, monkeypatch):
    """Five steps of ``train`` from the bridged f32 weights: at each step
    JAX's ``make_train_step`` (the example's optimizer) takes the port's
    params, AdamW state and batch of that step, and its loss is held to
    the port's within 1e-5 relative (``tests/test_torch_train_parity.py``'s
    rule for one step).  Each step starts from the port's own state: two
    free-running trajectories part by Adam's sign of the rounding on
    elements whose gradient is within the packages' f32 disagreement of
    0 (the parity file's step rule), which moves the loss by ~1e-3 after
    four steps at lr 3e-3.  The batches are JAX's ``Pipeline``'s, the
    first state JAX's ``init_params``, the printed lines the example's."""
    from repro.data.pipeline import DataConfig, Pipeline
    from repro.models.init import init_params
    from repro.optim.adamw import AdamWConfig, init_opt_state
    from repro.training.train import TrainConfig, make_train_step
    jcfg = jax_train.CFG_2M.replace(dtype="float32")
    jparams = init_params(jcfg, jax.random.key(0))
    jopt = init_opt_state(jparams)
    tparams = params_from_numpy(to_numpy(jparams), device="cpu")
    tcfg = train_100m.CFG_2M.replace(dtype="float32")
    jstep = make_train_step(jcfg, TrainConfig(optimizer=AdamWConfig(
        lr=3e-3, warmup_steps=10, total_steps=STEPS)))
    pipe = Pipeline(DataConfig(jcfg.vocab_size, SEQ, BATCH))
    seen = []
    real = train_100m.make_train_step

    def recording(cfg, tc):
        step = real(cfg, tc)

        def run(params, opt, batch):
            seen.append((to_numpy_tree(params), to_numpy_tree(opt),
                         batch["tokens"].numpy().copy()))
            return step(params, opt, batch)
        return run

    monkeypatch.setattr(train_100m, "make_train_step", recording)
    out, lines = captured(train_100m.train, tcfg, tparams, steps=STEPS,
                          batch=BATCH, seq=SEQ, ckpt_dir=str(tmp_path),
                          device="cpu")
    assert len(seen) == STEPS
    want = []
    for k, (p, opt, tokens) in enumerate(seen):
        np.testing.assert_array_equal(tokens, pipe.batch(k)["tokens"])
        _, _, m = jstep(_to_jax(p, jparams), _to_jax(opt, jopt),
                        {"tokens": jnp.asarray(tokens)})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_REL)
    from repro.models.init import count_params
    assert lines[0] == f"repro-2m: {count_params(jcfg)/1e6:.1f}M params"
    assert lines[1] == f"step    0  loss {out['losses'][0]:.4f}"
    assert lines[-1].startswith(f"loss: {out['first']:.3f} -> ")


def to_numpy_tree(tree):
    """A detached copy of a port state tree (its leaves cloned)."""
    from repro_torch.core.tree import tree_map
    return tree_map(lambda a: a.detach().clone(), tree)


class Interrupted(Exception):
    pass


def test_interrupted_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    """10 steps of 2 x 32 tokens, a checkpoint every 4 (the example's
    cadence is 40 of 120): a run the pipeline stops at step 6 restarts
    with ``resume`` from step 4 and ends on the uninterrupted run's
    params and AdamW moments, bit for bit; the resumed run prints the
    JAX example's ``resumed at step`` line."""
    cfg = train_100m.CFG_2M
    kw = dict(steps=10, batch=2, seq=32, device="cpu", ckpt_every=4)

    def fresh():
        return train_100m.weights(cfg, torch.device("cpu"), 0)

    whole, _ = captured(train_100m.train, cfg, fresh(),
                        ckpt_dir=str(tmp_path / "a"), **kw)
    real = train_100m.Pipeline

    class Stops(real):
        def batch(self, step):
            if step == 6:
                raise Interrupted(step)
            return super().batch(step)

    monkeypatch.setattr(train_100m, "Pipeline", Stops)
    with pytest.raises(Interrupted):
        captured(train_100m.train, cfg, fresh(),
                 ckpt_dir=str(tmp_path / "b"), **kw)
    monkeypatch.setattr(train_100m, "Pipeline", real)
    again, lines = captured(train_100m.train, cfg, fresh(),
                            ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    assert "resumed at step 4" in lines and again["start"] == 4
    assert again["losses"] == whole["losses"][4:]
    for tree in ("params", "opt"):
        a = dict(leaves_with_path(whole[tree]))
        b = dict(leaves_with_path(again[tree]))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
