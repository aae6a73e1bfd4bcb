"""The port's training path (``optim/adamw.py``, ``data/pipeline.py``,
``DecoderLM``/``HybridSSM.loss_fn``, ``train/trainer.py`` and
``launch/train.py``) against the JAX package, on the CPU.

The reference's ``run_training`` fails on this tree (a ``ShardingTypeError``
under its debug mesh), so the port is held against the reference's
single-device pieces: ``model.loss_fn`` under ``jax.value_and_grad``,
``trainer._grad_fn`` and ``adamw.apply_updates`` under ``jax.jit`` with no
mesh. Parameters come from the reference's init through
``models.weights.from_reference``, and the batches from the reference's
``synth_batch``.

Tolerances: ``lr_at`` within 1e-7 relative; ``apply_updates`` within
1e-6 + 1e-6 |x| (XLA and torch round the same f32 formula in other
orders), its step count exact; the loss within 1e-5 (the hybrid 1e-4) and
the gradients' ``global_norm(g_port - g_ref) / global_norm(g_ref)`` below
1e-5 (the hybrid 1e-4: its chunked scan sums more terms in another order);
five train steps' losses within 1e-4 and their metrics within 1e-5
relative (the hybrid's gradient norm within its gradients' 1e-4).
Parameters after an update are compared only through the later losses: Adam's first step is about ``g / |g|``, so a gradient element at
rounding level may flip its sign and move by 2 lr on one side only.
"""
import gc
import os
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RCN
from repro.data import pipeline as ref_data
from repro.models.transformer import get_model as ref_get_model
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch import configs as CN
from repro_torch.data import pipeline as data
from repro_torch.launch import train as launch
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import get_model
from repro_torch.models.weights import from_reference
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import MeshShape
from repro_torch.train import trainer

ARCHS = ("llama3.2-1b", "zamba2-1.2b")
LOSS_TOL = {"llama3.2-1b": 1e-5, "zamba2-1.2b": 1e-4}
GRAD_TOL = {"llama3.2-1b": 1e-5, "zamba2-1.2b": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_tree(tree):
    return from_reference(to_np(tree), "cpu")


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def rel_err(got, want) -> float:
    diff = tree_map(lambda a, b: a.float() - b.float(), got, want)
    return float(adamw.global_norm(diff) / adamw.global_norm(want))


def reference(arch, batch=4, seq=32):
    """The reference's smoke model, its init and its step-0 batch."""
    model = ref_get_model(RCN.get_smoke_config(arch))
    params, _ = model.init(jax.random.PRNGKey(0))
    dcfg = ref_data.DataConfig(vocab_size=model.cfg.vocab_size, batch=batch,
                               seq_len=seq)
    return model, params, dcfg


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    for s in range(0, kw["total_steps"] + 6):
        got = float(adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_adamw.lr_at(rcfg, jnp.int32(s)))
        assert got == pytest.approx(want, rel=1e-7, abs=0.0), (s, got, want)


def random_tree(rng):
    """Nested f32 leaves of rank 0 to 3 (weight decay applies to rank >= 2
    only), in an order that is not sorted."""
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "sub": {"z": rng.standard_normal((2, 3, 4)).astype(np.float32),
                    "a": np.float32(rng.standard_normal())}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moment_dtype):
    rng = np.random.default_rng(3)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, moment_dtype=moment_dtype)
    cfg, rcfg = adamw.AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    rp = jax.tree_util.tree_map(jnp.asarray, random_tree(rng))
    ropt = ref_adamw.init_opt_state(rcfg, rp)
    p, opt = port_tree(rp), adamw.init_opt_state(cfg, port_tree(rp))
    step = jax.jit(lambda p, g, o: ref_adamw.apply_updates(rcfg, p, g, o))
    for i in range(4):
        # gradients large enough that the clip acts on some steps
        g = jax.tree_util.tree_map(
            jnp.asarray, random_tree(rng))
        if i % 2:
            g = jax.tree_util.tree_map(lambda x: x * 0.01, g)
        rp, ropt, rm = step(rp, g, ropt)
        p, opt, m = adamw.apply_updates(cfg, p, port_tree(g), opt)
        # each step starts from the reference's state, so errors never pile
        for got, want in ((p, rp), (opt["m"], ropt["m"]),
                          (opt["v"], ropt["v"])):
            for a, b in zip(tree_leaves(got),
                            jax.tree_util.tree_leaves(want)):
                b = np.asarray(b, np.float32)
                np.testing.assert_allclose(a.float().numpy(), b,
                                           atol=1e-6, rtol=1e-6)
        assert int(opt["step"]) == int(ropt["step"]) == i + 1
        assert opt["m"]["w"].dtype == getattr(torch, moment_dtype)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        p, opt = port_tree(rp), {"m": port_tree(ropt["m"]),
                                 "v": port_tree(ropt["v"]),
                                 "step": torch.tensor(i + 1,
                                                      dtype=torch.int32)}


def test_global_norm_sums_in_sorted_key_order():
    """The leaves are summed in the reference's order whatever the dicts'
    insertion order."""
    a = {"b": torch.tensor([3.0]), "a": torch.tensor([4.0])}
    assert [float(x) for x in tree_leaves(a)] == [4.0, 3.0]
    assert float(adamw.global_norm(a)) == 5.0


# ------------------------------------------------------- loss and gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rmodel, rparams, dcfg = reference(arch)
    batch = ref_data.synth_batch(dcfg, 0)
    (rloss, rmet), rgrads = jax.value_and_grad(
        rmodel.loss_fn, has_aux=True)(rparams, batch)
    model = get_model(CN.get_smoke_config(arch))
    params = trainer.trainable(port_tree(rparams))
    grads, loss, met = trainer._grad_fn(model, 1)(params, port_batch(batch))
    assert sorted(met) == sorted(rmet)
    for k in met:
        assert float(met[k]) == pytest.approx(float(rmet[k]),
                                              abs=LOSS_TOL[arch])
    assert float(loss) == pytest.approx(float(rloss), abs=LOSS_TOL[arch])
    assert rel_err(grads, port_tree(rgrads)) < GRAD_TOL[arch]


@pytest.mark.parametrize("arch,microbatches,free", [
    ("llama3.2-1b", 1, True), ("llama3.2-1b", 4, True),
    ("zamba2-1.2b", 1, False)])
def test_train_steps_match_reference(arch, microbatches, free):
    """Five steps of ``make_train_step`` against the reference's
    ``_grad_fn`` + ``apply_updates`` under ``jax.jit`` (no mesh), each on
    the reference's batches. The dense model runs ``free``: the port from
    its own state. The hybrid's gradients agree to 1e-4 only, and a
    rounding-level gradient whose sign flips moves its parameter by 2 lr,
    which its next gradient norm shows at 3e-4: so each of its steps starts
    from the reference's state."""
    rmodel, rparams, dcfg = reference(arch, batch=8, seq=16)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    rcfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rgrads_of = ref_trainer._grad_fn(rmodel, microbatches)

    @jax.jit
    def rstep(p, o, b):
        g, loss, met = rgrads_of(p, b)
        p, o, om = ref_adamw.apply_updates(rcfg, p, g, o)
        return p, o, dict(met, **om, loss=loss)

    step = trainer.make_train_step(CN.get_smoke_config(arch), cfg,
                                   microbatches=microbatches)
    ropt = ref_adamw.init_opt_state(rcfg, rparams)
    params = trainer.trainable(port_tree(rparams))
    opt = adamw.init_opt_state(cfg, params)
    for s in range(5):
        if not free:
            params = trainer.trainable(port_tree(rparams))
            opt = {"m": port_tree(ropt["m"]), "v": port_tree(ropt["v"]),
                   "step": torch.tensor(s, dtype=torch.int32)}
        batch = ref_data.synth_batch(dcfg, s)
        rparams, ropt, rmet = rstep(rparams, ropt, batch)
        params, opt, met = step(params, opt, port_batch(batch))
        assert sorted(met) == sorted(rmet)
        assert float(met["loss"]) == pytest.approx(float(rmet["loss"]),
                                                   abs=1e-4)
        for k in met:
            assert float(met[k]) == pytest.approx(
                float(rmet[k]), rel=GRAD_TOL[arch], abs=1e-5), (s, k)
    assert all(p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    """``remat="block"`` recomputes the blocks in the backward: the same
    loss and gradients, bit for bit, on the CPU."""
    out = []
    for remat in ("none", "block"):
        model = get_model(CN.get_smoke_config(arch, remat=remat))
        params = trainer.trainable(model.init(0, "cpu"))
        batch = data.synth_batch(data.DataConfig(model.cfg.vocab_size, 2, 16),
                                 0, "cpu")
        out.append(trainer._grad_fn(model, 1)(params, batch))
    (g0, l0, _), (g1, l1, _) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_microbatches_equal_one_pass():
    """Four microbatches (rows j, j + 4, ...) against one pass over the
    batch: the reference's own bound (rel 1e-5 loss, 1e-4 gradients)."""
    cfg = CN.get_smoke_config("llama3.2-1b")
    model = get_model(cfg)
    params = trainer.trainable(model.init(0, "cpu"))
    batch = data.synth_batch(data.DataConfig(cfg.vocab_size, 8, 16), 0, "cpu")
    g1, l1, _ = trainer._grad_fn(model, 1)(params, batch)
    g4, l4, _ = trainer._grad_fn(model, 4)(params, batch)
    assert float(l4) == pytest.approx(float(l1), rel=1e-5)
    assert rel_err(g4, g1) < 1e-4


def test_a_step_frees_its_gradients_without_the_cycle_collector():
    """The gradients a step returns are freed once the caller drops them,
    with the cyclic collector off: no reference cycle keeps a whole
    gradient tree alive past its step (``tree_unflatten``)."""
    cfg = CN.get_smoke_config("llama3.2-1b")
    model = get_model(cfg)
    params = trainer.trainable(model.init(0, "cpu"))
    batch = data.synth_batch(data.DataConfig(cfg.vocab_size, 4, 16), 0, "cpu")
    gc.collect()
    gc.disable()
    try:
        grads, _, _ = trainer._grad_fn(model, 1)(params, batch)
        refs = [weakref.ref(g) for g in tree_leaves(grads)]
        del grads
        assert refs and all(r() is None for r in refs)
    finally:
        gc.enable()


def test_unported_training_arguments_are_refused():
    """FSDP needs a mesh to shard over, and the compressed step a mesh
    with a ``pod`` axis (the reference asserts it)."""
    cfg = CN.get_smoke_config("llama3.2-1b")
    opt = adamw.AdamWConfig()
    with pytest.raises(ValueError, match="mesh"):
        trainer.make_train_step(cfg, opt, fsdp=True)
    with pytest.raises(ValueError, match="pod"):
        trainer.make_compressed_train_step(cfg, opt, None, object())
    with pytest.raises(ValueError, match="pod"):
        trainer.make_compressed_train_step(
            cfg, opt, MeshShape(("data", "model"), (2, 2)), object())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    for get, rget in ((CN.get_smoke_config, RCN.get_smoke_config),
                      (CN.get_config, RCN.get_config)):
        assert get(arch).param_count() == rget(arch).param_count()
        assert get(arch).active_param_count() == \
            rget(arch).active_param_count()


# --------------------------------------------------------- crash-restart

def final_checkpoint(d, steps):
    return dict(np.load(os.path.join(d, f"ckpt_{steps:08d}.npz")))


def test_crash_restart_is_bit_exact_on_cpu(tmp_path):
    """A fault at step 6 rolls back to step 4's checkpoint and replays the
    data: the final state equals an uninterrupted run's bit for bit."""
    kw = dict(steps=12, batch=4, seq=32, smoke=True, ckpt_every=4,
              log_every=100, device="cpu")
    a = launch.run_training("llama3.2-1b", ckpt_dir=str(tmp_path / "a"),
                            fault_at=[6], **kw)
    b = launch.run_training("llama3.2-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert a["restarts"] == 1 and b["restarts"] == 0
    assert a["restored_from"] == [4] and b["restored_from"] == []
    assert a["final_step"] == b["final_step"] == 12
    za, zb = (final_checkpoint(str(tmp_path / d), 12) for d in "ab")
    assert set(za) == set(zb)
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for x, y in zip(tree_leaves(a["state"]),
                    tree_leaves(b["state"])):
        assert torch.equal(x, y)
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]


def test_restart_waits_for_the_checkpoint_in_flight(tmp_path, monkeypatch):
    """Faults right after the saves of steps 4 and 8, while those writes
    are still on their thread (each takes 0.3 s more here): each restart
    resumes from the checkpoint just saved, not an older one or none."""
    savez = np.savez

    def slow_savez(*a, **k):
        time.sleep(0.3)
        savez(*a, **k)

    monkeypatch.setattr(np, "savez", slow_savez)
    out = launch.run_training("llama3.2-1b", steps=10, batch=2, seq=16,
                              ckpt_every=4, fault_at=[4, 8], log_every=100,
                              ckpt_dir=str(tmp_path), device="cpu")
    assert out["restarts"] == 2 and out["restored_from"] == [4, 8]


def test_training_cli_on_cpu(tmp_path, capsys):
    launch.main(["--arch", "zamba2-1.2b", "--steps", "3", "--batch", "2",
                 "--seq", "16", "--ckpt-every", "0", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert '"final_step": 3' in out and '"restarts": 0' in out
    assert os.listdir(tmp_path) == ["ckpt_00000003.npz"]


# ------------------------------------------------------------------ data

def test_data_pipeline_is_deterministic_and_shifted():
    cfg = data.DataConfig(vocab_size=101, batch=4, seq_len=32, seed=3)
    a, b = data.synth_batch(cfg, 17, "cpu"), data.synth_batch(cfg, 17, "cpu")
    c = data.synth_batch(cfg, 18, "cpu")
    d = data.synth_batch(data.DataConfig(101, 4, 32, seed=4), 17, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert torch.equal(a["labels"][:, -1], a["tokens"][:, 0])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 101
    it = data.data_iterator(cfg, 17, "cpu")
    assert torch.equal(next(it)["tokens"], a["tokens"])
    assert torch.equal(next(it)["tokens"], c["tokens"])


def repeat_share(tokens: np.ndarray, V: int) -> float:
    """The copy probability rho that explains the share of tokens equal to
    their predecessor: P(equal) = rho (1 - rho) + rho^2 q + (1 - rho) q,
    q the chance that two Zipf draws collide, P(rank = k - 1) =
    log((k + 1) / k) / log V."""
    k = np.arange(1, V, dtype=np.float64)
    q = float(np.sum((np.log1p(1.0 / k) / np.log(V)) ** 2))
    eq = float(np.mean(tokens[:, 1:] == tokens[:, :-1]))
    # solve (q - 1) rho^2 + (1 - q) rho + q - eq = 0 for the root in [0, .5]
    a, b, c = q - 1.0, 1.0 - q, q - eq
    return (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)


def test_data_pipeline_law_matches_reference():
    """Over 64 batches: the copy share within 0.02 of 0.3 in both packages,
    and the mean log-rank within 2 % of the reference's."""
    V = 32000
    cfg, rcfg = data.DataConfig(V, 8, 128), ref_data.DataConfig(V, 8, 128)
    port = np.concatenate([data.synth_batch(cfg, s, "cpu")["tokens"].numpy()
                           for s in range(64)])
    ref = np.concatenate([np.asarray(ref_data.synth_batch(rcfg, s)["tokens"])
                          for s in range(64)])
    assert abs(repeat_share(port, V) - 0.3) < 0.02
    assert abs(repeat_share(ref, V) - 0.3) < 0.02
    lp, lr = np.mean(np.log1p(port)), np.mean(np.log1p(ref))
    assert abs(lp - lr) < 0.02 * lr
