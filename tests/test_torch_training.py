"""The port's training substrate, as ``tests/test_training.py`` holds the
JAX package's: convergence, microbatch equivalence, checkpoint restart
(bit for bit), checkpoint GC, error-feedback compression; plus tiny
rwkv and jamba steps (the recurrent layers train), the refusals (a mesh,
a group of more than one), the train CLI with a resume and on rwkv, and
the pieces shared with the JAX package:
``Pipeline`` batches byte-equal, checkpoints that restore across the
packages bit for bit under equal manifest keys, ``topk_sparsify``.

Tolerances as in the JAX suite: microbatch equivalence 5e-2 abs / rel;
the compressed mean 1e-4 abs.  The port's weights are its own
``init_params`` (seed 0); the cross-package checks carry JAX's.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import disk as jdisk  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.configs.tiny import make_tiny as jtiny  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.models.init import init_params as jinit  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.checkpoint import disk  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.configs.tiny import make_tiny  # noqa: E402
from repro_torch.core.tree import host_array, leaves, leaves_with_path  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Pipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.init import init_params, params_from_numpy  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training.train import (TrainConfig, make_train_step,  # noqa: E402
                                        train_step)
from tests.torch_helpers import to_numpy  # noqa: E402

CFG = make_tiny(get("llama-1.5b"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module: the tiny models' ops are too
    small to split, and under the suite's six workers on a shared CPU the
    split cost up to 30x the module's time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0, cfg=CFG):
    return init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                       device="cpu")


def _run(steps, tcfg, seed=0, params=None, opt=None, start=0):
    params = params or _params(seed)
    opt = opt or init_opt_state(params)
    pipe = Pipeline(DataConfig(CFG.vocab_size, 32, 4, noise=0.02))
    fn = make_train_step(CFG, tcfg)
    losses = []
    for s in range(start, start + steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
        params, opt, m = fn(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, opt, losses


def test_loss_decreases():
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=2e-3, warmup_steps=3,
                                             total_steps=40))
    _, _, losses = _run(30, tcfg)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_microbatch_equivalence():
    """grad-accum over 4 microbatches == single big batch (same update)."""
    t1 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=1,
                     z_loss=0.0)
    t4 = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=4,
                     z_loss=0.0)
    p1, _, _ = _run(3, t1, seed=5)
    p4, _, _ = _run(3, t4, seed=5)
    for a, b in zip(leaves(p1), leaves(p4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-2, rtol=5e-2)


def test_checkpoint_restart_exact_continuation(tmp_path):
    """Fault tolerance: stop at step 10, restart from the checkpoint; the
    final params and optimizer state must be IDENTICAL to the
    uninterrupted run (stateless pipeline + deterministic step)."""
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=2,
                                             total_steps=20))
    p_full, o_full, _ = _run(20, tcfg, seed=3)
    p10, o10, _ = _run(10, tcfg, seed=3)
    disk.save(str(tmp_path), 10, {"params": p10, "opt": o10})
    tree = disk.restore(str(tmp_path), 10, {"params": p10, "opt": o10})
    p_res, o_res, _ = _run(10, tcfg, seed=3, params=tree["params"],
                           opt=tree["opt"], start=10)
    for a, b in zip(leaves({"p": p_full, "o": o_full}),
                    leaves({"p": p_res, "o": o_res})):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            "restart diverged from clean run"


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        disk.save(str(tmp_path), s, {"x": torch.ones(3)}, keep=2)
    assert disk.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert disk.latest_step(str(tmp_path / "absent")) is None


def test_error_feedback_compression_recovers_signal():
    """int8 error feedback through ``compressed_psum`` over a group of
    one: the accumulated mean converges to the true gradient (the
    residual carries the rounding error), step for step as the JAX
    quantizer's loop."""
    rng = np.random.default_rng(0)
    g_np = (rng.standard_normal(512) * 0.01).astype(np.float32)
    g = {"w": torch.from_numpy(g_np)}
    r = compression.init_residuals(g)
    assert r["w"].dtype == torch.float32 and not r["w"].any()
    acc = torch.zeros(512)
    jr, jacc = jnp.zeros(512), jnp.zeros(512)
    for _ in range(50):
        mean, r = compression.compressed_psum(g, r)
        acc = acc + mean["w"]
        v = jnp.asarray(g_np) + jr
        q, s = jcomp.quantize_int8(v)
        deq = jcomp.dequantize_int8(q, s)
        jr, jacc = v - deq, jacc + deq
    np.testing.assert_allclose((acc / 50).numpy(), g_np, atol=1e-4)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1e-6)


def test_compressed_psum_refuses_a_larger_group(monkeypatch):
    """Only a group of one is ported: a group of two is refused loudly,
    naming the queue (no silent single-member mean)."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    g = {"w": torch.ones(4)}
    with pytest.raises(NotImplementedError, match="sharding.py"):
        compression.compressed_psum(g, compression.init_residuals(g),
                                    group=object())


def test_compressed_step_with_a_group_of_one(monkeypatch):
    """``compress_pod_grads`` with a group carries residuals through the
    step; without a group the step is the plain one, as the JAX step is
    without a "pod" mesh."""
    import torch.distributed as dist

    class One:
        pass
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), compress_pod_grads=True)
    params = _params(1)
    batch = {k: torch.from_numpy(v) for k, v in Pipeline(
        DataConfig(CFG.vocab_size, 32, 4)).batch(0).items()}
    res = compression.init_residuals(params)
    with monkeypatch.context() as mp:
        mp.setattr(dist, "get_world_size", lambda group=None: 1)
        p1, _, m, res1 = train_step(params, init_opt_state(params), batch,
                                    cfg=CFG, tcfg=tc, residuals=res,
                                    group=One())
    assert any(bool(r.any()) for r in leaves(res1))
    p0, _, _, same = train_step(params, init_opt_state(params), batch,
                                cfg=CFG, tcfg=tc, residuals=res)
    assert all(not r.any() for r in leaves(same))
    assert all(torch.isfinite(a).all() for a in leaves(p1))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_train_step_refuses_recurrent_layers(arch):
    """rwkv and mamba layers train (the refusal this test held is gone):
    a tiny step, through ``make_train_step`` and ``train_step`` alike,
    gives a finite loss and grad norm and moves the params, the mixers'
    own among them, while the inputs stay untouched."""
    cfg = make_tiny(get(arch))
    params = _params(0, cfg)
    opt = init_opt_state(params)
    before = [a.clone() for a in leaves({"p": params, "o": opt})]
    batch = {k: torch.from_numpy(v) for k, v in Pipeline(
        DataConfig(cfg.vocab_size, 64, 2)).batch(0).items()}
    tc = TrainConfig(AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    p1, _, m = make_train_step(cfg, tc)(params, opt, batch)
    p2, _, _ = train_step(params, opt, batch, cfg=cfg, tcfg=tc)
    assert all(torch.equal(a, b) for a, b in zip(leaves(p1), leaves(p2)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    mixer = "rwkv" if arch == "rwkv6-7b" else "mamba"
    moved = {k for (k, a), b in zip(leaves_with_path(p1), leaves(params))
             if not torch.equal(a, b)}
    assert any(f"['{mixer}']" in k for k in moved), sorted(moved)[:5]
    assert len(moved) > len(leaves(params)) // 2
    assert all(torch.isfinite(a.float()).all() for a in leaves(p1))
    assert all(torch.equal(a, b) for a, b in
               zip(before, leaves({"p": params, "o": opt})))


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="sharding.py"):
        make_train_step(CFG, TrainConfig(), mesh=object())


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU prints the JAX CLI's lines,
    checkpoints, and a second run with ``--resume`` continues from the
    last checkpoint; ``--arch rwkv6-7b`` trains (a 24-token sequence:
    two chunks of 8 and a ragged tail); a cuda run without a card exits
    1."""
    ck = str(tmp_path / "ck")

    def argv(steps, *more):
        return ["--tiny", "--device", "cpu", "--steps", str(steps),
                "--batch", "4", "--seq", "32", "--ckpt-dir", ck,
                "--ckpt-every", "3", "--log-every", "1", *more]
    assert train_cli.main(argv(6)) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training llama-1.5b-tiny: ")
    steps = [ln for ln in out if ln.startswith("step ")]
    assert len(steps) == 6 and all(" loss " in s and " ce " in s
                                   and " gnorm " in s for s in steps)
    assert out[-1] == "done"
    assert sorted(os.listdir(ck)) == ["step_00000003", "step_00000006"]
    assert train_cli.main(argv(8, "--resume")) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 6"
    assert [ln.split()[1] for ln in out if ln.startswith("step ")] \
        == ["6", "7"]
    assert disk.latest_step(ck) == 8
    assert train_cli.main(["--arch", "rwkv6-7b", "--tiny", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq",
                           "24", "--log-every", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training rwkv6-7b-tiny: ")
    assert len([ln for ln in out if ln.startswith("step ")]) == 2
    assert out[-1] == "done"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            train_cli.main(["--tiny", "--steps", "1"])
        assert "is_available() is False" in str(e.value)


def test_pipeline_batches_equal_jax_bytes():
    """Three steps x two hosts (and one host), byte for byte."""
    for hosts in (1, 2):
        for h in range(hosts):
            cfg = (512, 40, 4)
            mine = Pipeline(DataConfig(*cfg), host_id=h, num_hosts=hosts)
            theirs = JPipeline(JDataConfig(*cfg), host_id=h,
                               num_hosts=hosts)
            for step in range(3):
                a, b = mine.batch(step)["tokens"], theirs.batch(step)["tokens"]
                assert a.dtype == b.dtype == np.int32
                assert a.shape == (4 // hosts, 40)
                assert a.tobytes() == b.tobytes()


def _jax_state():
    """A JAX tiny llama's params (bf16) and an optimizer state with live
    moments and step 1."""
    jcfg = jtiny(jget("llama-1.5b"))
    jp = jinit(jcfg, jax.random.key(0))
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), jp)
    jp, opt, _ = jax.jit(jadamw.apply_updates, static_argnums=3)(
        jp, grads, jadamw.init_opt_state(jp), jadamw.AdamWConfig())
    return {"params": jp, "opt": opt}


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "MANIFEST.json")) as f:
        return json.load(f)


def test_checkpoints_cross_the_packages_bit_for_bit(tmp_path):
    """A JAX ``disk.save`` of {params, opt} and a uint16 leaf restores in
    the port bit for bit, each leaf's torch dtype the one its manifest
    names (a uint16 leaf as uint16, not as bf16 bits); the port's
    ``save`` of it restores with the JAX ``restore`` bit for bit; both
    manifests hold the same keys, files, shapes and dtype strings."""
    jtree = {**_jax_state(), "ids": jnp.arange(5, dtype=jnp.uint16) * 9000}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdisk.save(jdir, 7, jtree)
    like = params_from_numpy(to_numpy(jtree), device="cpu")
    tree = disk.restore(jdir, 7, like)
    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(to_numpy(jtree))[0]}
    got = leaves_with_path(tree)
    assert [k for k, _ in got] == list(want)
    names = {k: m["dtype"] for k, m in _manifest(jdir, 7)["leaves"].items()}
    for k, t in got:
        a = host_array(t)
        assert a.dtype == want[k].dtype and a.tobytes() == want[k].tobytes(), k
        assert t.dtype == getattr(torch, names[k]), k
    assert tree["opt"]["step"].dtype == torch.int32
    assert tree["params"]["embed"].dtype == torch.bfloat16
    assert tree["ids"].dtype == torch.uint16
    assert tree["ids"].tolist() == [0, 9000, 18000, 27000, 36000]

    disk.save(tdir, 7, tree)
    assert _manifest(tdir, 7) == _manifest(jdir, 7)
    back = jdisk.restore(tdir, 7, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_topk_sparsify_matches_jax():
    g = np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32)
    for frac in (0.01, 0.1, 0.5):
        out, kept = compression.topk_sparsify(torch.from_numpy(g), frac)
        jout, jkept = jcomp.topk_sparsify(jnp.asarray(g), frac)
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert float(kept) == float(jkept)
