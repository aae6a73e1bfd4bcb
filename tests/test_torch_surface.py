"""The port's public surface against the JAX package, on the CPU.

``repro_torch.core`` and ``repro_torch.ops`` export the reference's names
(``JaxEngine`` mapped to ``TorchEngine``); every registered engine
satisfies the ``Engine`` protocol; ``as_spec`` behaves as the reference's;
the single-replica ``vdes.simulate`` cut by a wave or a time budget and
resumed equals one uncut call **bit for bit** and the reference's
``vdes.simulate`` on a pinned integer-time workload (no fleet stage: the
reference's fails, ROADMAP queue 3, a); the masked cross entropy and
``layer_norm`` are within 1e-6 of the reference's on seeded inputs; and
``init_train_state(comp=)`` gives the reference's zero error-state leaves,
which survive a checkpoint round trip.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.ops as ref_ops
import repro_torch.core as core
import repro_torch.ops as ops
from repro import configs as RCN
from repro.core import experiment as ref_exp
from repro.core import model as RM
from repro.core import vdes as ref_vdes
from repro.models import common as ref_common
from repro.optim import adamw as ref_adamw
from repro.parallel import compression as ref_comp
from repro.train import trainer as ref_trainer
from repro_torch import configs as CN
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import engines, experiment, vdes
from repro_torch.core import model as M
from repro_torch.models import common
from repro_torch.models.common import tree_items
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.train import trainer
from test_des_engines import make_workload

N, T, HORIZON = 60, 3, 400.0
BACKOFF = (4.0, 2.0, 16.0)
SIM_KEYS = ("start", "finish", "ready", "attempts", "done", "waves")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def public_names(mod):
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not inspect.ismodule(v)}


def test_core_exports_equal_reference():
    want = {"TorchEngine" if n == "JaxEngine" else n
            for n in public_names(ref_core)}
    assert public_names(core) == want
    for name in want:
        assert getattr(core, name) is not None


def test_ops_exports_equal_reference():
    assert ops.__all__ == ref_ops.__all__
    assert public_names(ops) == public_names(ref_ops)
    for name in ops.__all__:
        assert hasattr(ops, name), name


@pytest.mark.parametrize("name", ["numpy", "torch", "torch-compact",
                                  "torch-stream"])
def test_engines_satisfy_protocol(name):
    eng = engines.get_engine(name, "cpu")
    assert isinstance(eng, core.Engine)
    assert eng.name == name
    # the protocol's members are the reference's
    want = {n for n in vars(ref_core.Engine) if not n.startswith("_")}
    assert {n for n in vars(core.Engine) if not n.startswith("_")} == want


class _Legacy:
    """A caller's own object that exposes ``to_spec``."""

    def __init__(self, spec):
        self.spec = spec

    def to_spec(self):
        return self.spec


def _spec(mod_exp, mod_m, w, **kw):
    return mod_exp.ExperimentSpec(
        name="s", horizon_s=HORIZON, workload=w,
        platform=mod_m.PlatformConfig(resources=(
            mod_m.ResourceConfig("a", 3), mod_m.ResourceConfig("b", 2))),
        **kw)


def test_as_spec_behaves_as_reference():
    w = make_workload(np.random.default_rng(4), 30, integer_time=True,
                      horizon=HORIZON)
    pw = M.Workload(**{f.name: getattr(w, f.name)
                       for f in dataclasses.fields(M.Workload)})
    rspec = _spec(ref_exp, RM, w, engine="numpy")
    pspec = _spec(experiment, M, pw)
    assert ref_exp.as_spec(rspec) is rspec
    assert experiment.as_spec(pspec) is pspec
    assert experiment.as_spec(_Legacy(pspec)) is pspec
    with pytest.raises(AttributeError):
        ref_exp.as_spec(object())
    with pytest.raises(AttributeError):
        experiment.as_spec(object())
    # run_experiment hands back the caller's own object, as the reference's
    leg = _Legacy(pspec)
    got = experiment.run_experiment(leg, device="cpu")
    want = ref_exp.run_experiment(_Legacy(rspec))
    assert got.experiment is leg
    assert got.summary["mean_wait_s"] == want.summary["mean_wait_s"]
    # Sweep's base goes through as_spec too
    axes = {"capacity:b": [1, 2]}
    pts = experiment.Sweep(_Legacy(pspec), axes).points()
    rpts = ref_exp.Sweep(_Legacy(rspec), axes).points()
    assert [p.name for p in pts] == [p.name for p in rpts]
    assert [list(p.platform.capacities) for p in pts] == \
        [list(p.platform.capacities) for p in rpts]


@pytest.fixture(scope="module")
def sim_case():
    """A pinned whole-second workload with retries (1-3 attempts per task)
    and a backoff, on two pools."""
    rng = np.random.default_rng(20261018)
    w = make_workload(rng, N, max_tasks=T, integer_time=True,
                      horizon=HORIZON)
    attempts = rng.integers(1, 4, (N, T)).astype(np.int32)
    plat = RM.PlatformConfig(resources=(RM.ResourceConfig("a", 3),
                                        RM.ResourceConfig("b", 2)))
    caps = np.asarray(plat.capacities, np.int32)
    ref = ref_vdes.simulate(
        ref_vdes.VWorkload.from_workload(w, plat, attempts),
        jnp.asarray(caps), backoff=jnp.asarray(BACKOFF, jnp.float32))
    pw = M.Workload(**{f.name: getattr(w, f.name)
                       for f in dataclasses.fields(M.Workload)})
    pplat = M.PlatformConfig(resources=(M.ResourceConfig("a", 3),
                                        M.ResourceConfig("b", 2)))
    vwl = vdes.VWorkload.from_workload(pw, pplat, attempts, device="cpu")
    return vwl, caps, {k: np.asarray(v) for k, v in ref.items()}


def port_sim(case, **kw):
    vwl, caps, _ = case
    return vdes.simulate(vwl, caps, backoff=BACKOFF, device="cpu", **kw)


def assert_same_run(got, want):
    for k in SIM_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_simulate_uncut_equals_reference(sim_case):
    got = port_sim(sim_case)
    assert_same_run(got, sim_case[2])
    assert int(got["waves"]) > 40 and bool(got["done"].all())


@pytest.mark.parametrize("cut", ["wave", "time"])
def test_simulate_cut_and_resumed_equals_uncut(sim_case, cut):
    """Three segments under budgets, then the rest: every output key equal
    to the uncut call, and at each cut ``running`` / ``n_keep`` and the
    common state keys equal the reference's cut at the same budget."""
    whole = port_sim(sim_case)
    vwl, caps, _ = sim_case
    rvwl = ref_vdes.VWorkload(*(None if x is None else jnp.asarray(x.numpy())
                                for x in (vwl.arrival, vwl.n_tasks,
                                          vwl.task_res, vwl.service,
                                          vwl.priority, vwl.attempts)))
    budgets = ([7, 19, 33] if cut == "wave" else [60.0, 150.0, 260.0])
    state, rstate = None, None
    for b in budgets:
        kw = {"wave_budget" if cut == "wave" else "time_budget": b}
        seg = port_sim(sim_case, resume=state, return_state=True, **kw)
        rseg = ref_vdes.simulate(
            rvwl, jnp.asarray(caps), backoff=jnp.asarray(BACKOFF, jnp.float32),
            resume=rstate, return_state=True, **kw)
        assert bool(seg["running"]) == bool(rseg["running"]) is True
        assert int(seg["n_keep"]) == int(rseg["n_keep"])
        for k in ("phase", "wave", "start", "finish", "t_next"):
            np.testing.assert_array_equal(seg["state"][k].numpy(),
                                          np.asarray(rseg["state"][k]),
                                          err_msg=f"{b}: {k}")
        state, rstate = seg["state"], rseg["state"]
        if cut == "wave":
            assert int(seg["waves"]) == b
    assert_same_run(port_sim(sim_case, resume=state), whole)


def test_simulate_zero_budget_returns_initial_state(sim_case):
    seg = port_sim(sim_case, wave_budget=0, return_state=True)
    assert int(seg["waves"]) == 0 and bool(seg["running"])
    # the replica axis is gone from the state, as from every output
    assert seg["state"]["start"].shape == seg["start"].shape
    assert seg["state"]["wave"].dim() == 0
    assert_same_run(port_sim(sim_case, resume=seg["state"]),
                    port_sim(sim_case))


@pytest.mark.parametrize("masked", ["none", "some", "all_zero"])
def test_cross_entropy_loss_equals_reference(masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(0.0, 3.0, (2, 9, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    mask = {"none": None,
            "some": (rng.uniform(size=(2, 9)) < 0.6).astype(np.float32),
            "all_zero": np.zeros((2, 9), np.float32)}[masked]
    want = float(ref_common.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))
    got = float(common.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    if masked == "all_zero":
        assert got == 0.0


def test_layer_norm_equals_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(1.5, 2.0, (3, 5, 64)).astype(np.float32)
    g = rng.normal(1.0, 0.1, (64,)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (64,)).astype(np.float32)
    want = np.asarray(ref_common.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                            jnp.asarray(b)))
    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def test_init_train_state_error_feedback_equals_reference(tmp_path):
    comp = compression.CompressionConfig(kind="int8")
    cfg = CN.get_smoke_config("llama3.2-1b")
    opt = adamw.AdamWConfig()
    st = trainer.init_train_state(cfg, opt, 0, "cpu", comp=comp)
    ref = ref_trainer.init_train_state(
        RCN.get_smoke_config("llama3.2-1b"), ref_adamw.AdamWConfig(),
        jax.random.PRNGKey(0), comp=ref_comp.CompressionConfig(kind="int8"))
    want = _ref_leaves(ref.err_state)
    got = dict(tree_items(st.err_state))
    assert set(got) == set(want)
    for k, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert leaf.dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        assert not leaf.any(), k
    # no error feedback: None in both, and a state without one
    for kw in (dict(kind="none"), dict(kind="int8", error_feedback=False)):
        assert trainer.init_train_state(
            cfg, opt, 0, "cpu",
            comp=compression.CompressionConfig(**kw)).err_state is None
    assert trainer.init_train_state(cfg, opt, 0, "cpu").err_state is None
    # a checkpoint round trip of the whole state, error feedback included
    first = next(v for _, v in tree_items(st.err_state))
    first.add_(torch.randn(first.shape).to(torch.bfloat16))
    tree = {"params": st.params, "opt_state": st.opt_state,
            "err_state": st.err_state}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree, block=True)
    back = mgr.restore(3, tree)
    for (pa, a), (pb, b) in zip(tree_items(tree), tree_items(back)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a.detach(), b), pa
