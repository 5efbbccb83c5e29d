"""``chip_smoke.traced_ticks`` on the CPU, with its trace faked: a traced
window of graph replays must hold every port launch the replays counted,
a window whose trace lost a record is marked incomplete and taken again
only while the caller allows more windows, the last short window fails,
and a trace holding more launches than were counted fails at once. The
profiler is replaced by a list of fake kernel records, one per launch, of
which a test drops some.
"""
import contextlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch import kernels  # noqa: E402

PER_TICK = {"crossbar_matmul": 30, "selective_scan": 7, "moe_route": 4}


class _Range:
    def elapsed_us(self):
        return 1.0


class _Event:
    def __init__(self, name):
        self.name = name
        self.time_range = _Range()


class _Engine:
    """Counts as a replayed graph does: each tick adds its launches."""

    def __init__(self, replay=True):
        self.replays = 0
        self.prefill_tokens = 0
        self.replay = replay

    def step(self):
        for k, n in PER_TICK.items():
            kernels.LAUNCHES[k] += n
        self.replays += self.replay


def _kernel_name(key):
    names = next(names for keys, names in chip_smoke.LAUNCHED_AS
                 if key in keys)
    return f"void (anonymous namespace)::{names[0]}(float*)"


@pytest.fixture
def fake_trace(monkeypatch):
    """Windows whose trace drops ``drops[i]`` crossbar records (window i),
    or adds records where the count is negative."""
    drops, lost = [], [0]

    @contextlib.contextmanager
    def trace():
        before = dict(kernels.LAUNCHES)
        yield
        drop = drops.pop(0) if drops else 0
        events = []
        for k in PER_TICK:
            n = kernels.LAUNCHES[k] - before[k]
            if k == "crossbar_matmul":
                n -= drop
            events += [_Event(_kernel_name(k))] * n
        fake_trace.events = events

    fake_trace.events = []
    monkeypatch.setattr(chip_smoke, "cuda_trace", trace)
    monkeypatch.setattr(chip_smoke, "device_events",
                        lambda prof: fake_trace.events)
    monkeypatch.setattr(chip_smoke, "lost_launches", lambda prof: lost[0])
    monkeypatch.setattr(chip_smoke.torch.cuda, "synchronize", lambda: None)
    kernels.reset_launches()
    yield drops, lost
    kernels.reset_launches()


def test_a_whole_window_of_replays_is_complete_at_once(fake_trace):
    eng = _Engine()
    out = chip_smoke.traced_ticks(eng, 8, eng.step)
    assert out["complete"] and out["replayed"]
    assert out["ticks_run"] == 8 and len(out["attempts"]) == 1
    assert out["traced_launches_per_tick"]["crossbar_matmul"] == 30
    assert not chip_smoke.retrace(out)


def test_a_short_window_fails_where_no_other_window_is_allowed(fake_trace):
    drops, _ = fake_trace
    drops.append(1)
    eng = _Engine()
    with pytest.raises(AssertionError, match="window 1 of 1"):
        chip_smoke.traced_ticks(eng, 8, eng.step)


@pytest.mark.parametrize("short_windows", [1, 2])
def test_a_short_window_is_taken_again_and_kept_in_attempts(
        fake_trace, short_windows):
    drops, _ = fake_trace
    drops += [1] * short_windows
    eng, trace, windows = _Engine(), None, 0
    while chip_smoke.retrace(trace):
        trace = chip_smoke.traced_ticks(eng, 8, eng.step, trace,
                                        chip_smoke.TRACE_ATTEMPTS)
        windows += 1
    assert windows == short_windows + 1
    assert trace["complete"] and trace["ticks_run"] == 8 * windows
    assert [a["traced"]["crossbar_matmul"] for a in trace["attempts"]] == (
        [239] * short_windows + [240])
    assert all(a["counted"]["crossbar_matmul"] == 240
               for a in trace["attempts"])


def test_the_last_allowed_short_window_fails(fake_trace):
    drops, _ = fake_trace
    drops += [1] * chip_smoke.TRACE_ATTEMPTS
    eng, trace = _Engine(), None
    with pytest.raises(AssertionError, match="window 3 of 3"):
        while chip_smoke.retrace(trace):
            trace = chip_smoke.traced_ticks(eng, 8, eng.step, trace,
                                            chip_smoke.TRACE_ATTEMPTS)


def test_more_records_than_launches_fail_at_once(fake_trace):
    drops, _ = fake_trace
    drops.append(-1)
    eng = _Engine()
    with pytest.raises(AssertionError, match="window 1 of 3"):
        chip_smoke.traced_ticks(eng, 8, eng.step, None,
                                chip_smoke.TRACE_ATTEMPTS)


@pytest.mark.parametrize("lost, complete", [(2, True), (1, False)])
def test_eager_ticks_may_fall_short_by_the_launches_that_lost_records(
        fake_trace, lost, complete):
    drops, lost_now = fake_trace
    drops.append(2)
    lost_now[0] = lost
    eng = _Engine(replay=False)
    out = chip_smoke.traced_ticks(eng, 4, eng.step, None,
                                  chip_smoke.TRACE_ATTEMPTS)
    assert not out["replayed"] and out["complete"] == complete
