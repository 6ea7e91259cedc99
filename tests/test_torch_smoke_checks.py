"""Helpers of ``chip_smoke.py``'s checks, on the CPU: the profiler windows
that ``check_profiled_windows`` expects against those ``torch.profiler``'s
schedule makes, and the sparse seen mask of the quality phase against the
dense mask that ``check_eval_lists`` reads elsewhere."""
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
