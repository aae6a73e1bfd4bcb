"""Integer-time stage ensembles shared by the twins of the port's
controller, reliability, probe and lifecycle stages.

An ensemble is built twice from the same numpy draws: with the
reference's host side (its ``compile``/``stack_*`` functions) and with the
port's. The two stacked column sets must be equal bit for bit; the port's
go through ``to_tensors`` into its ``simulate_ensemble`` on the CPU, the
reference's into the JAX ``vdes.simulate_ensemble`` (default ``"fused"``
admission) and, replica by replica, into the numpy engine
``des.simulate``. Times are whole seconds, so f32 and f64 agree and the
port must equal both **exactly**, wave counts included (the numpy engine's
where a replica needs no padding rows: a padding row arrives at
``PAD_ARRIVAL`` and runs waves the numpy engine never sees).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.core import batching as ref_batching
from repro.core import des as ref_des
from repro.core import model as RM
from repro.core import vdes as ref_vdes
from repro_torch.core import batching, vdes
from repro_torch.core import model as M
from test_des_engines import make_workload

R, N, T, HORIZON = 4, 40, 3, 600.0
CAPS = (4, 3)
POSITIONAL = ("arrival", "n_tasks", "task_res", "service", "priority")


def platforms():
    """The reference's and the port's two-pool platform."""
    return tuple(mod.PlatformConfig(resources=(
        mod.ResourceConfig("a", CAPS[0], 1.0),
        mod.ResourceConfig("b", CAPS[1], 3.0))) for mod in (RM, M))


def workloads(seed, sizes=(N,) * R, horizon=HORIZON):
    """Whole-second reference workloads from ``seed`` (one per size)."""
    return [make_workload(np.random.default_rng(seed * 100 + i), n,
                          max_tasks=T, integer_time=True, horizon=horizon)
            for i, n in enumerate(sizes)]


def port_workload(w):
    return M.Workload(**{f.name: getattr(w, f.name)
                         for f in dataclasses.fields(w)})


def assert_same(a, b, path):
    """Arrays (numpy or tensors) equal exactly, NaN == NaN, same dtype
    kind and shape."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    assert a.dtype.kind == b.dtype.kind, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def assert_same_cols(ref_cols, port_cols):
    """The two host sides stacked the same columns, bit for bit."""
    assert set(ref_cols) == set(port_cols), set(ref_cols) ^ set(port_cols)
    for k in ref_cols:
        assert_same(ref_cols[k], port_cols[k], k)


def run_port(cols, caps, policies=None):
    return {k: v.numpy() for k, v in vdes.simulate_ensemble(
        **batching.to_tensors(cols, "cpu"), capacities=caps,
        policies=policies, device="cpu").items()}


def run_jax(cols, caps, policies=None):
    cols = dict(cols)
    cols.pop("n_max", None)
    pos = [jnp.asarray(cols.pop(k)) for k in POSITIONAL]
    static = {k: cols.pop(k) for k in list(cols) if k.startswith("n_")}
    out = ref_vdes.simulate_ensemble(
        *pos, jnp.asarray(caps), policies=policies,
        **{k: jnp.asarray(v) for k, v in cols.items()}, **static)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_same_outputs(port, ref):
    """Every output key of the reference's ensemble, equal in the port's."""
    assert set(port) == set(ref), set(port) ^ set(ref)
    for k in ref:
        assert_same(port[k], ref[k], k)


def numpy_trace(wl, plat, policy, comp, K, **stages):
    """``des.simulate`` of one replica with its scenario's schedule padded
    to the batch's ``K`` change points, as the batch runs it."""
    if comp is not None:
        sched = comp.schedule.padded(K, HORIZON)
        comp = dataclasses.replace(
            comp, schedule=dataclasses.replace(comp.schedule,
                                               times=sched.times,
                                               caps=sched.caps))
    return ref_des.simulate(wl, plat, policy, scenario=comp, **stages)


def stacked(ref_comps, port_comps, ref_wls, port_wls, plats, services=True):
    """Both host sides' padded workloads and stacked scenarios."""
    rp, pp = plats
    rc = ref_batching.pad_workloads(ref_wls, rp)
    pc = batching.pad_workloads(port_wls, pp)
    svc = [w.service_time(rp.datastore) for w in ref_wls]
    if ref_comps is not None:
        rc.update(ref_batching.stack_scenarios(ref_comps, rc["n_max"],
                                               HORIZON, services=svc))
        pc.update(batching.stack_scenarios(port_comps, pc["n_max"], HORIZON,
                                           services=svc))
    return rc, pc


def same_tree(a, b):
    """Nested summary dicts equal, NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


def without_wall(summary):
    return {k: v for k, v in summary.items() if k not in ("wall_s",
                                                            "pipelines_per_s")}
