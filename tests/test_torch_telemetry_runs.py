"""The telemetry plane's runners, port against JAX, on the CPU.

``run_chunked(telemetry_stream=)``'s rows and its refusal, ``sweep_dyn``
and ``sweep_dyn_from`` grids of telemetry worlds against JAX's vmapped
runs, and the phase spans under the profiler.  The worlds themselves are
in ``tests/test_torch_telemetry.py``.
"""
import numpy as np
import pytest
import torch

from fognetsimpp_tpu.core import engine as jengine
from fognetsimpp_tpu.parallel import sweep as jsweep
from fognetsimpp_tpu.scenarios import smoke as jsmoke
from fognetsimpp_tpu_torch.core import engine as tengine
from fognetsimpp_tpu_torch.parallel import sweep as tsweep
from fognetsimpp_tpu_torch.parallel.replicas import strict_vmap
from fognetsimpp_tpu_torch.scenarios import smoke as tsmoke
from fognetsimpp_tpu_torch.telemetry import metrics as tmetrics
from tests.test_torch_telemetry import SMALL
from tests.test_torch_v1v2 import assert_same


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tensors here are tiny: one thread beside the other
    test workers (torch's OpenMP pool would only spin)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_run_chunked_streams_the_reservoir_rows_as_jax():
    """Chunks of 30 ticks: the rows each chunk completed, in order and
    without repeats, equal JAX's stream, and their union is the final
    reservoir; the final state equals JAX's undonated chunked run."""
    kw = dict(SMALL, telemetry=True, telemetry_reservoir=40)
    got, want = [], []
    spec, st, net, b = tsmoke.build(device="cpu", **kw)
    final = tengine.run_chunked(
        spec, st, net, b, 30, telemetry_stream=lambda rows, d: got.append((rows, d))
    )
    js, jst, jn, jb = jsmoke.build(**kw)
    jfinal = jengine.run_chunked(
        js, jst, jn, jb, 30, callback=lambda s, d: None,
        telemetry_stream=lambda rows, d: want.append((rows, d)),
    )
    assert_same(final, jfinal, "chunked")
    assert [d for _, d in got] == [d for _, d in want] == [30, 60, 90, 100]
    for (g, _), (w, _) in zip(got, want):
        for f in tmetrics.RES_FIELDS:
            assert g[f].tobytes() == np.asarray(w[f]).tobytes(), f
    res = tmetrics.telemetry_summary(spec, final)["reservoir"]
    for f in tmetrics.RES_FIELDS:
        np.testing.assert_array_equal(np.concatenate([r[f] for r, _ in got]), res[f])


def test_run_chunked_stream_requires_telemetry():
    spec, st, net, b = tsmoke.build(device="cpu", **SMALL)
    js, jst, jn, jb = jsmoke.build(**SMALL)
    msgs = []
    for fn, args in ((tengine.run_chunked, (spec, st, net, b)),
                     (jengine.run_chunked, (js, jst, jn, jb))):
        with pytest.raises(ValueError, match="telemetry_stream") as e:
            fn(*args, 50, telemetry_stream=lambda rows, d: None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


#: A grid world: telemetry, the histogram and journeys on.
GRID_KW = dict(
    SMALL, horizon=0.06, fog_mips=(100000.0,), telemetry=True, telemetry_hist=True,
    telemetry_journeys=8, telemetry_journey_ring=8, uplink_loss_prob=0.05,
)


def test_sweep_dyn_grids_of_telemetry_worlds_match_jax():
    """A mid-run telemetry carry forked onto an uplink-loss grid
    (``sweep_dyn_from``): the batched final state, telemetry leaves
    included, equals JAX's; and ``sweep_dyn`` over the same grid from t=0
    (one replica a cell) gives JAX's counters."""
    knobs = {"uplink_loss_prob": [0.05, 0.3]}
    spec, st, net, b = tsmoke.build(device="cpu", **GRID_KW)
    mid, _ = tengine.run(spec, st, net, b, n_ticks=30)
    with strict_vmap():
        grid, final = tsweep.sweep_dyn_from(spec, mid, net, b, knobs, 30)
    js, jst, jn, jb = jsmoke.build(**GRID_KW)
    jmid, _ = jengine.run(js, jst, jn, jb, n_ticks=30)
    jgrid, jfinal = jsweep.sweep_dyn_from(js, jmid, jn, jb, knobs, 30)
    assert grid == jgrid
    assert_same(final, jfinal, "sweep_dyn_from")
    assert (final.telem.lat_hist.sum(dim=(1, 2)) > 0).all()
    kw = dict(GRID_KW, horizon=0.02)
    with strict_vmap():
        cells = tsweep.sweep_dyn(tsmoke.build, knobs, device="cpu", **kw)
    jcells = jsweep.sweep_dyn(jsmoke.build, knobs, **kw)
    assert len(cells) == len(jcells) == 2
    for g, w in zip(cells, jcells):
        for k, v in w["counters"].items():
            assert np.asarray(v).tobytes() == g["counters"][k].tobytes(), k


def test_phase_spans_open_only_under_the_profiler():
    """``record_function("phase_<name>")`` spans around the phases while a
    profiler records; without one the span is a no-op context."""
    from torch.profiler import ProfilerActivity, profile

    assert not torch.autograd._profiler_enabled()
    span = tengine._span("spawn")
    assert not isinstance(span, torch.profiler.record_function)
    spec, st, net, b = tsmoke.build(device="cpu", **dict(SMALL, horizon=0.004))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tengine.run(spec, st, net, b)
    names = {e.key for e in prof.key_averages()}
    assert {"phase_adverts", "phase_spawn", "phase_broker", "phase_fog_arrivals"} <= names
