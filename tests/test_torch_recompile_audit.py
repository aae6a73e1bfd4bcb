"""The port's recompile audit (``repro_torch.analysis.recompile_audit``):
the 32-point mixed smoke grid (capacity x controller x trigger x probe x
reliability) reaches ``simulate_ensemble`` as ONE call whose rows, each
recorded alone, run ONE wave program; a doctored runner that dispatches
each point alone is caught, and so is a grid whose rows run different
programs; the streaming driver's window calls share one signature. The
fourth check (one kernel library per kernel) runs on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

from repro_torch.analysis.harness import (CapturedCall, call_signature,
                                          capture_calls, smoke_controller,
                                          smoke_spec, smoke_stream_spec,
                                          smoke_sweep)
from repro_torch.analysis.recompile_audit import (_batch_rows, _slice_row,
                                                  row_program_hash,
                                                  run_recompile_audit)
from repro_torch.core.engines import TorchStreamEngine
from repro_torch.core.experiment import Sweep


@pytest.fixture(scope="module")
def grid_call():
    sweep = smoke_sweep()
    assert len(sweep.points()) == 32
    with capture_calls() as calls:
        results = sweep.run(device="cpu")
    assert len(results) == 32
    return calls


def test_mixed_sweep_is_one_call(grid_call):
    """The 32-point grid: one simulate_ensemble call, every axis value in
    the batch tensors of that one call."""
    assert len(grid_call) == 1, "grid must lower to ONE simulate_ensemble call"
    assert _batch_rows(grid_call[0]) == 32


def test_row_slices_trace_to_one_program(grid_call):
    """Each of the 32 rows, sliced out and one wave of it recorded alone,
    runs the same program: no axis value is baked into the wave program's
    Python control flow or literals."""
    call = grid_call[0]
    hashes = {row_program_hash(_slice_row(call, b)) for b in range(32)}
    assert len(hashes) == 1


def test_audit_clean_on_production_sweep_path():
    fs = run_recompile_audit(".", device="cpu", hash_rows=False)
    assert fs == [], [f.render() for f in fs]


def test_audit_catches_per_point_dispatch():
    """A runner that runs each grid point on its own (what an axis that
    became a static argument degenerates into) is flagged: two calls, two
    signatures (the controller splits the scenario tensors: present vs
    absent) and two wave programs."""
    sweep = Sweep(smoke_spec(engine="torch"),
                  {"controller": [None, smoke_controller()]})

    def per_point_runner(sw):
        for p in sw.points():
            Sweep(p, {}).run(device="cpu")

    fs = run_recompile_audit(".", sweep=sweep, runner=per_point_runner,
                             hash_rows=False, device="cpu")
    rules = [f.rule for f in fs]
    assert rules and set(rules) == {"recompile"}
    msgs = " | ".join(f.message for f in fs)
    assert "2 simulate_ensemble calls instead of 1" in msgs
    assert "distinct call signatures" in msgs
    assert "distinct wave programs" in msgs


def test_audit_catches_rows_with_different_programs():
    """Rows whose trigger cooldowns differ bound the redeploy-gain fold
    (``vdes.gain_order_bound``) differently when each runs alone: the
    batched call is still one program, but the sliced rows trace to two,
    and the row check names it."""
    sweep = Sweep(smoke_spec(engine="torch"),
                  {"trigger:cooldown_s": [0.0, 200.0]})
    fs = run_recompile_audit(".", sweep=sweep, device="cpu")
    assert [f.rule for f in fs] == ["recompile"]
    assert "recording the 2 batch rows alone yields 2 distinct wave " \
        "programs" in fs[0].message


def test_program_hash_agrees_with_make_fx(grid_call):
    """The row check's hash of an eager run equals where ``make_fx``'s
    traced graphs are equal: two rows of the mixed grid (one program), and
    the two rows of a cooldown sweep (two programs: the redeploy-gain fold
    is bounded per row) under both."""
    from torch.fx.experimental.proxy_tensor import make_fx
    sweep = Sweep(smoke_spec(engine="torch"),
                  {"trigger:cooldown_s": [0.0, 200.0]})
    with capture_calls() as calls:
        sweep.run(device="cpu")
    rows = [_slice_row(grid_call[0], 0), _slice_row(grid_call[0], 1),
            _slice_row(calls[0], 0), _slice_row(calls[0], 1)]
    hashes, codes = [], []
    for row in rows:
        prog = row.program()
        codes.append(make_fx(prog.wave, tracing_mode="real")(prog.state).code)
        hashes.append(row_program_hash(row))
    for i in range(4):
        for j in range(4):
            assert (hashes[i] == hashes[j]) == (codes[i] == codes[j])
    assert hashes[0] == hashes[1] and hashes[2] != hashes[3]


def test_call_signature_separates_static_arguments():
    """Two otherwise-identical calls that differ in a static argument map
    to different signatures."""
    arr = np.zeros((2, 3), np.float32)
    a = CapturedCall((arr,), {"n_probe_slots": 3})
    b = CapturedCall((arr,), {"n_probe_slots": 5})
    c = CapturedCall((arr,), {"n_probe_slots": 3})
    assert call_signature(a) != call_signature(b)
    assert call_signature(a) == call_signature(c)


def test_stream_window_calls_share_one_signature():
    """Across all windows of the full-stack smoke stream on
    ``"torch-stream"``, every ``resume``-carrying ``simulate_ensemble``
    call has ONE signature, and the only other is the state-materializing
    first call: a stream whose backlog stays inside one width bucket runs
    two wave programs, ever."""
    spec = smoke_stream_spec()
    eng = TorchStreamEngine(window_s=spec.horizon_s / 5, device="cpu")
    with capture_calls() as calls:
        res = eng.run(spec)
    assert res.summary["n_windows"] == 5
    sigs = {call_signature(c) for c in calls}
    window_sigs = {call_signature(c) for c in calls
                   if c.kwargs.get("resume") is not None}
    assert len(window_sigs) == 1
    assert len(sigs) == 2
