"""The port's checkpoints, fault injector and the simulator's bridge to the
training launcher (``checkpoint/manager.py``, ``CheckpointSpec.injector``),
on the CPU.

Checkpoints restore bit for bit (bf16 leaves included: they are stored as
their uint16 bits); the manager keeps the last ``keep_last`` steps and
refuses a shape mismatch, as the reference's does. The injector's failure
steps equal the reference's on the same compiled reliability scenario,
exactly.
"""
import numpy as np
import pytest
import torch

from repro import reliability as RR
from repro.checkpoint.manager import FaultInjector as RefFaultInjector
from repro.core import model as RM
from repro_torch import reliability as PR
from repro_torch.checkpoint.manager import CheckpointManager, FaultInjector
from repro_torch.core import model as M
from repro_torch.core.workload import generate_empirical_workload
from repro_torch.models.common import tree_leaves


def state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((2, 3), generator=g),
                       "e": torch.randn((4, 2), generator=g).bfloat16(),
                       "b": torch.randn(3, generator=g)},
            "opt_state": {"m": {"w": torch.randn((2, 3), generator=g)},
                          "step": torch.tensor(7, dtype=torch.int32)}}


def assert_bits_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_and_keep_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    st = state()
    for s in (10, 20, 30):
        mgr.save(s, st, block=True)
    assert mgr.all_steps() == [20, 30]     # keep_last=2 removed step 10
    assert mgr.latest_step() == 30
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000020.npz", "ckpt_00000030.npz"]    # no .tmp left behind
    assert_bits_equal(mgr.restore(30, st), st)
    assert int(mgr.restore(30, st)["opt_state"]["step"]) == 7


def test_bf16_leaves_restore_bit_for_bit(tmp_path):
    """bf16 values that an f32 round trip would keep are not enough: every
    one of the 65,536 bit patterns, NaNs and infinities included."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    st = {"x": bits.view(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st, block=True)
    z = np.load(tmp_path / "ckpt_00000001.npz")
    assert z["x"].dtype == np.uint16
    got = mgr.restore(1, st)["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), bits)


def test_restore_casts_to_target_and_refuses_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((2, 2))}, block=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"w": torch.ones((3, 3))})
    with pytest.raises(KeyError, match="missing leaf v"):
        mgr.restore(1, {"v": torch.ones((2, 2))})
    got = mgr.restore(1, {"w": torch.zeros((2, 2), dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and bool((got["w"] == 1).all())


def test_async_save_then_restore(tmp_path):
    """The save copies to the host before it returns: updating the tree in
    place afterwards changes nothing in the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    st = state()
    want = {"params": {k: v.clone() for k, v in st["params"].items()},
            "opt_state": st["opt_state"]}
    mgr.save(5, st)
    st["params"]["w"].add_(1.0)
    st["params"]["e"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [5]
    assert_bits_equal(mgr.restore(5, st), want)


def test_restore_reads_any_savez_archive_and_refuses_corruption(tmp_path):
    """``restore`` reads the archive's stored members itself: one written
    by ``np.savez`` directly (no ``__dtypes__``: the reference's format; a
    Fortran-ordered leaf, a 0-d one) restores value for value, and a
    member whose bytes changed fails its CRC-32."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = tmp_path / "ckpt_00000002.npz"
    with open(path, "wb") as f:
        np.savez(f, **{"p/w": np.asfortranarray(w), "p/s": np.int32(4),
                       "p/v": np.arange(5, dtype=np.float64)})
    mgr = CheckpointManager(str(tmp_path))
    target = {"p": {"w": torch.zeros((3, 4)), "s": torch.tensor(0),
                    "v": torch.zeros(5, dtype=torch.float64)}}
    got = mgr.restore(2, target)
    assert torch.equal(got["p"]["w"], torch.from_numpy(w))
    assert got["p"]["s"].dtype == torch.int64 and int(got["p"]["s"]) == 4
    assert torch.equal(got["p"]["v"], torch.arange(5, dtype=torch.float64))
    raw = bytearray(path.read_bytes())
    at = raw.rfind(np.arange(5, dtype=np.float64).tobytes())
    raw[at + 9] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(2, target)


def test_fault_injector_fires_once_per_step():
    for inj in (FaultInjector([3, 5]), RefFaultInjector([3, 5])):
        fired = []
        for _ in range(2):                 # a replay after a restart
            for step in range(7):
                try:
                    inj.maybe_fail(step)
                except RuntimeError as e:
                    fired.append(step)
                    assert str(e) == f"injected node failure at step {step}"
        assert fired == [3, 5]


def rel_spec(mod, H, stride):
    return mod.ReliabilitySpec(
        topology=mod.TopologySpec(zones=2, racks_per_zone=4),
        outages=mod.DomainOutageModel(zone_mtbf_s=H / 2.0, rack_mtbf_s=H / 4.0,
                                      mttr_s=H / 24.0),
        repair=mod.RepairSpec(crews=2),
        spot=mod.SpotPoolSpec(frac=0.2, evict_mtbe_s=H / 3.0,
                              reclaim_s=H / 48.0),
        checkpoint=mod.CheckpointSpec(fault_step_stride=stride),
        time_quantum_s=1.0)


@pytest.mark.parametrize("stride", [60.0, 2160.0])
def test_checkpoint_spec_injector_equals_reference(stride):
    """The same compiled scenario gives the same failure steps."""
    H = 86400.0
    wl = generate_empirical_workload(0, 0.1 * H)
    rc = RR.compile_reliability(rel_spec(RR, H, stride), wl,
                                RM.PlatformConfig(), H, seed=3)
    pc = PR.compile_reliability(rel_spec(PR, H, stride), wl,
                                M.PlatformConfig(), H, seed=3)
    want = rel_spec(RR, H, stride).checkpoint.injector(rc)
    got = rel_spec(PR, H, stride).checkpoint.injector(pc)
    assert isinstance(got, FaultInjector)
    assert len(pc.events) >= 3
    assert got.fail_at == want.fail_at
    assert got.fail_at == {int(ev.t_down // stride) for ev in pc.events}
