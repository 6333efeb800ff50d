"""The traced run's reductions: the slice schedule, the device's busy
union and span, idle gaps charged to the host's innermost operation, and
a kernel family that a slice missed."""
import pytest
from torch.profiler import ProfilerAction

from portbench import trace


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_schedule_records_slices_at_fractions():
    clock = Clock()
    s = trace.SliceSchedule(10.0, (0.2, 0.6), 2, clock)
    s.start()
    actions = []
    for step in range(12):
        clock.t = step * 1.0
        actions.append(s(step))
    A = ProfilerAction
    assert actions[:2] == [A.NONE, A.NONE]
    assert actions[2:5] == [A.WARMUP, A.RECORD, A.RECORD_AND_SAVE]
    assert actions[5] == A.NONE
    assert actions[6:9] == [A.WARMUP, A.RECORD, A.RECORD_AND_SAVE]
    assert set(actions[9:]) == {A.NONE}


def test_reduce_events_busy_span_and_gaps():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0),
              ("copy", 52.0, 60.0)]
    host = [("outer", 0.0, 100.0), ("aten::index_put_", 21.0, 39.0)]
    r = trace.reduce_events(device, host)
    assert r.span_s == pytest.approx(60e-6)
    assert r.busy_s == pytest.approx((20 + 10 + 8) * 1e-6)
    assert r.device_ops["k1"] == [pytest.approx(20e-6), 2]
    # the 20 us gap falls in index_put_, the 2 us one is launch latency
    assert r.idle_by_host["aten::index_put_"] == pytest.approx(20e-6)
    assert r.idle_by_host["launch latency (< 5 us)"] == pytest.approx(2e-6)
    assert trace.reduce_events([], host) is None


def test_family_missing_from_a_slice_fails():
    t = trace.Trace(1.0, (0.5,), 1, Clock())
    t.slices = [trace.SliceReading(1.0, 0.5, {"void block_direction_kernel"
                                              "<5, false, float>": [0.1, 4]},
                                   {}),
                trace.SliceReading(1.0, 0.5, {"other": [0.1, 1]}, {})]
    with pytest.raises(RuntimeError):
        t.family_seconds(r"\bblock_direction_kernel\b")
    t.slices = t.slices[:1]
    assert t.family_seconds(r"\bblock_direction_kernel\b") == (0.1, 4)
    assert t.busy_s == 0.5 and t.window_s == 1.0


def test_quiet_steps_skip_profiled_neighbours():
    t = trace.Trace(1.0, (0.5,), 1, Clock())
    A = ProfilerAction
    t.actions = [A.NONE, A.NONE, A.NONE, A.WARMUP, A.RECORD_AND_SAVE,
                 A.NONE, A.NONE, A.NONE]
    t.ends = [float(i) for i in range(8)]
    assert t.quiet_steps() == [2, 6, 7]
    assert t.quiet_periods() == [1.0, 1.0, 1.0]
