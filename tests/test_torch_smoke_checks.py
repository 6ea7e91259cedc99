"""Helpers of ``chip_smoke.py``'s checks, on the CPU: the profiler windows
that ``check_profiled_windows`` expects against those ``torch.profiler``'s
schedule makes, the sparse seen mask of the quality phase against the
dense mask that ``check_eval_lists`` reads elsewhere, and the profiler
sessions taken again where one recorded no kernel (``profiled``)."""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile, schedule

import chip_smoke


def _profiler_windows(steps: int, window):
    """The steps torch.profiler records in each window it hands to
    ``on_trace_ready`` over ``steps`` steps, counted as chip_smoke counts
    them (the profiler's action at each step)."""
    skip, warmup, active, repeat = window
    recorded, out = [0], []

    def ready(_):
        out.append(recorded[0])
        recorded[0] = 0

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU], on_trace_ready=ready,
                     schedule=schedule(skip_first=skip, wait=0, warmup=warmup,
                                       active=active, repeat=repeat)) as prof:
            for _ in range(steps):
                torch.ones(2).add_(1)
                recorded[0] += prof.current_action in (ProfilerAction.RECORD,
                                                       ProfilerAction.RECORD_AND_SAVE)
                prof.step()
    return out


@pytest.mark.parametrize("steps", [1, 2, 50, 101, 102, 202, 976])
@pytest.mark.parametrize("window", [chip_smoke.TRAIN_PROFILE_WINDOW, (100, 1, 100, 3),
                                    (3, 2, 10, 0)])
def test_schedule_windows_are_the_profilers(steps, window):
    assert chip_smoke.schedule_windows(steps, window) == _profiler_windows(steps, window)


def test_default_windows_cover_each_training():
    """Every step of a training is recorded but one warm-up step a window."""
    for steps in (67, 976, 1010):
        wins = chip_smoke.schedule_windows(steps)
        assert sum(wins) == steps - len(wins)


def test_check_profiled_windows_holds_the_counts():
    steps = 250
    wins = chip_smoke.schedule_windows(steps)
    exact = [{n: s for n in chip_smoke.BPR_KERNELS} for s in wins]
    run = {"steps": steps, "bpr_profiled": exact, "profiled_steps": wins}
    assert chip_smoke.check_profiled_windows(run) == {n: 0 for n in chip_smoke.BPR_KERNELS}
    lost_one = [dict(w) for w in exact]
    lost_one[0]["bpr_fwd_tile_kernel"] -= 1
    assert chip_smoke.check_profiled_windows(dict(run, bpr_profiled=lost_one))[
        "bpr_fwd_tile_kernel"] == 1
    for bad in ({"profiled_steps": [100] * len(wins)},          # not the schedule's
                {"bpr_profiled": [{n: s + 1 for n in chip_smoke.BPR_KERNELS}
                                  for s in wins]},             # more than its steps
                {"bpr_profiled": [{n: s - 1 for n in chip_smoke.BPR_KERNELS}
                                  for s in wins]}):            # no window exact
        with pytest.raises(AssertionError):
            chip_smoke.check_profiled_windows(dict(run, **bad))


def test_seen_rows_read_as_the_dense_mask():
    rng = np.random.default_rng(0)

    class View:
        user_id = rng.integers(1, 40, 500)
        item_id = rng.integers(1, 30, 500)

    dense = np.zeros((40, 30), dtype=bool)
    dense[View.user_id, View.item_id] = True
    users = [1, 5, 7, 39]
    seen = chip_smoke._SeenRows(View, users, 29)
    cols = rng.integers(0, 30, 12)
    for u in users:
        np.testing.assert_array_equal(seen[u, cols], dense[u, cols])
        np.testing.assert_array_equal(seen[u, 1:], dense[u, 1:])


class _Session:
    """A stand-in for ``torch.profiler.profile`` as ``profiled`` opens it."""

    def __init__(self, activities):
        self.activities = activities

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("sessions, keep, taken", [
    ([[], [], [("bpr_fwd", 5.0, 1)]], None, 3),
    ([[("mul", 2.0, 1)], [("bpr_bwd", 5.0, 1)]], lambda k: k.startswith("bpr_"), 2),
    ([[("mul", 2.0, 1)]], None, 1),
    ([[], [], [], [("bpr_fwd", 5.0, 1)]], None, chip_smoke.PROFILE_TRIES),  # gives up
])
def test_profiled_takes_a_new_session_while_it_records_nothing(monkeypatch, sessions,
                                                                keep, taken):
    """``profiled`` opens a new session, with a new ``setup()``, while the
    last one recorded no kernel that ``keep`` accepts, at most
    ``PROFILE_TRIES`` times, and returns the last session and the body's
    result in it."""
    import torch.profiler

    opened, setups = [], []

    def session(activities):
        opened.append(_Session(activities))
        return opened[-1]

    monkeypatch.setattr(torch.profiler, "profile", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_events",
                        lambda prof: iter(sessions[opened.index(prof)]))
    prof, res = chip_smoke.profiled(lambda s: ("ran", s), keep,
                                    setup=lambda: setups.append(1) or len(setups))
    assert len(opened) == len(setups) == taken <= chip_smoke.PROFILE_TRIES
    assert prof is opened[-1] and res == ("ran", taken)
    assert all(ProfilerActivity.CUDA in s.activities for s in opened)


@pytest.mark.parametrize("kernels, by, ms", [({"bpr_fwd": 0.125, "bpr_x": 0.25}, "profiler", 0.375),
                                             ({}, "events", 0.5)])
def test_bpr_device_ms_times_by_events_where_no_session_recorded(monkeypatch, kernels,
                                                                  by, ms):
    """The BPR phase's device time comes from the profiler's kernels, and
    from CUDA events where no session recorded them, which it says."""
    monkeypatch.setattr(chip_smoke, "device_kernel_ms", lambda fn, reps, keep=None: kernels)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 0.5)
    assert chip_smoke.bpr_device_ms("fwd", lambda: None) == {
        "fwd_device_kernels_ms": kernels, "fwd_device_ms_by": by, "fwd_device_ms": ms}
