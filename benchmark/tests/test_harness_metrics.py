"""The window's arithmetic, the trace reduction and the readers, on
synthetic records."""

import itertools

import pytest

from benchmark import harness, profile, window
from benchmark.profile import Interval, Trace


def fake_clock(step_times):
    """A clock that advances by each step's time inside its call."""
    now = [0.0]
    times = iter(step_times)

    def clock():
        return now[0]

    def step():
        now[0] += next(times)
        return now[0]

    return clock, step


def test_window_counts_every_step_until_the_time_is_up():
    clock, step = fake_clock([0.125] * 100)
    times, window_s, out = window.run_window(step, 1.0, clock)
    assert len(times) == 8 and window_s == 1.0 and out == 1.0


def test_rate_and_p95_over_the_whole_window():
    times = [0.1] * 40
    assert window.mean_ms(sum(times), len(times)) == pytest.approx(100.0)
    assert window.p95_ms(times) == pytest.approx(100.0)
    assert window.p95_ms(list(range(1, 101))) == pytest.approx(95_000.0)
    assert window.p95_ms([0.5]) == pytest.approx(500.0)


def test_a_stall_moves_both_the_rate_and_the_tail():
    steady = [0.1] * 40
    stalled = [0.1] * 37 + [0.6] * 3  # three stalled frames of 40
    base_rate = window.mean_ms(sum(steady), len(steady))
    rate = window.mean_ms(sum(stalled), len(stalled))
    assert rate > base_rate * 1.3
    assert window.p95_ms(stalled) == pytest.approx(600.0)
    assert window.p95_ms(steady) == pytest.approx(100.0)
    clock, step = fake_clock(stalled + [0.1] * 10)
    times, window_s, _ = window.run_window(step, 4.0, clock)
    assert window.mean_ms(window_s, len(times)) > base_rate


def test_busy_union_counts_overlap_once():
    assert profile.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert profile.busy_us([(0, 10), (2, 3), (10, 12)]) == 12
    assert profile.busy_us([]) == 0
    assert profile.merged([(5, 6), (0, 1)]) == [[0, 1], [5, 6]]


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
def test_busy_union_ignores_order(perm):
    ivs = [(0, 4), (3, 8), (10, 11)]
    assert profile.busy_us([ivs[i] for i in perm]) == 9


def test_idle_gaps_named_by_the_innermost_host_event():
    tr = Trace(
        device=[Interval("k1", 0, 10), Interval("k2", 20, 30),
                Interval("k3", 30, 40), Interval("k4", 100, 110)],
        host=[Interval("aten::outer", 0, 60), Interval("cudaSync", 12, 25)])
    gaps = dict(profile.idle_gaps(tr))
    assert gaps["cudaSync"] == pytest.approx(10e-6)
    assert gaps["python"] == pytest.approx(60e-6)
    ops = profile.top_device_ops(tr)
    assert [n for n, _ in ops][0] in ("k1", "k2", "k3", "k4")
    assert sum(s for _, s in ops) == pytest.approx(40e-6)


def record(**kw):
    rec = harness.Record(setup_s=12.5, build_s=9.0)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def read(name, rec):
    return harness._load_module(harness.reader_path(name),
                                "m_" + name.replace(".", "_")).read(rec)


def test_end_to_end_readers():
    rec = record(times=[0.1, 0.1, 0.4], window_s=0.6)
    assert read("setup_s", rec) == 12.5
    assert read("step_ms", rec) == pytest.approx(200.0)
    assert read("frame_ms", rec) == pytest.approx(200.0)
    assert read("frame_ms_p95", rec) == pytest.approx(400.0)
    assert read("frame_ms", record()) is None


def test_trace_readers():
    tr = Trace(
        device=[Interval("nearest_kernel(Args)", 0, 400),
                Interval("void anyhit_kernel<1>(x)", 500, 600),
                Interval("binned_nearest_kernel", 600, 700),
                Interval("Memcpy HtoD", 800, 900)],
        host=[Interval("autograd::engine::evaluate_function: MulBackward0",
                       0, 300),
              Interval("autograd::engine::evaluate_function: AddBackward0",
                       200, 500),
              Interval("aten::mul", 0, 50)])
    rec = record(trace=tr, traced_steps=2, traced_wall_s=2e-3,
                 window_peak_bytes=3 * 2**30)
    assert read("launches.step", rec) == 2
    assert read("traverse_ms.frame", rec) == pytest.approx(0.25)
    assert read("autograd_ms.step", rec) == pytest.approx(0.25)
    assert read("idle.step", rec) == pytest.approx(1 - 700e-6 / 2e-3)
    assert read("peak_mem_gib.frame", rec) == pytest.approx(3.0)


def test_readers_with_nothing_to_read_return_none():
    empty = record(trace=Trace(), traced_steps=1, traced_wall_s=1.0)
    for name in ("launches.frame", "traverse_ms.step", "autograd_ms.step",
                 "idle.frame", "peak_mem_gib.step", "epochs", "spec_eff",
                 "domain_loads"):
        assert read(name, empty) is None, name


def test_counter_readers_take_deltas_over_the_window():
    rec = record(traced_steps=2,
                 counters_before={"epochs": 10, "domain_loads": 300,
                                  "rays_traced": 1000, "committed": 100},
                 counters_after={"epochs": 80, "domain_loads": 900,
                                 "rays_traced": 3000, "committed": 600})
    assert read("epochs", rec) == 35
    assert read("domain_loads", rec) == 300
    assert read("spec_eff", rec) == pytest.approx(0.25)
