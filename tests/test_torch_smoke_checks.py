"""Helpers of ``chip_smoke.py``'s checks, on the CPU: the profiler windows
that ``check_profiled_windows`` expects against those ``torch.profiler``'s
schedule makes, the sparse seen mask of the quality phase against the
dense mask that ``check_eval_lists`` reads elsewhere, the profiler
sessions taken again where one recorded no kernel (``profiled``) or the
records of only some calls (``device_kernel_ms``), the kernels line's
rule that no kernel time is under its bound (``check_kernel_times``), the
record each phase starts with (``phase_start``) and the archive the
pipeline phase's ``data`` stage downloads (``write_ml1m_archive``,
``check_download``), and the dlrm_bags phase's work and checks at a small
shape (``dlrm_bags_rank``, ``check_dlrm_bags``)."""
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


@pytest.mark.parametrize("sessions, taken, want", [
    # the records of 7 of 50 calls (a reading of kernel 6 at (1,024, 64) once), then all 50
    ([[("bpr_bwd_tile_kernel", 7 * 19.7, 7), ("bpr_bwd_finish_kernel", 7 * 4.1, 7)],
      [("bpr_bwd_tile_kernel", 50 * 19.7, 50), ("bpr_bwd_finish_kernel", 50 * 4.1, 50)]],
     2, {"bpr_bwd_tile_kernel": 0.0197, "bpr_bwd_finish_kernel": 0.0041}),
    # two launches a call: 100 records are whole, 99 not
    ([[("bpr_x", 99.0, 99)], [("bpr_x", 100.0, 100)]], 2, {"bpr_x": 0.002}),
    # never whole: no reading (the caller times by events)
    ([[("bpr_bwd_tile_kernel", 1.0, 7)]] * chip_smoke.PROFILE_TRIES,
     chip_smoke.PROFILE_TRIES, {}),
])
def test_device_kernel_ms_retakes_a_session_short_of_calls(monkeypatch, sessions,
                                                           taken, want):
    """A session that kept the records of only some of the calls is not
    read as if it had them all: it is taken again, and where no session
    is whole there is no profiler reading."""
    import torch.profiler

    opened = []

    def session(activities):
        opened.append(_Session(activities))
        return opened[-1]

    monkeypatch.setattr(torch.profiler, "profile", session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "device_events",
                        lambda prof: iter(sessions[opened.index(prof)]))
    got = chip_smoke.device_kernel_ms(lambda: None, 50, lambda k: k.startswith("bpr_"))
    assert len(opened) == taken
    assert got.keys() == want.keys()
    for k, ms in want.items():
        assert got[k] == pytest.approx(ms)


def _kernels_line(**bwd):
    return [{"name": "window_mips", "ms": 0.55, "plain_ms": 22.1, "library_ms": None,
             "w512_10m_ms": 1.34, "w512_10m_bound_ms": 0.767, "bound_ms": 0.267,
             "bound_by": "operations"},
            {"name": "bpr_bwd", "ms": 0.577, "plain_ms": 0.25, "bound_ms": 0.0962,
             "ms_1024x64": 0.0238, "plain_ms_1024x64": 0.057, "bound_ms_1024x64": 0.0060,
             "bound_by": "operations", "library_ms": None, **bwd}]


def test_kernels_line_refuses_a_time_under_its_bound():
    """The kernels line cannot print a kernel time no card can give: each
    time (``ms``, ``ms_<shape>``, ``<path>_ms``) at or above its bound, and
    every time with one; plain and library times are not held to it."""
    chip_smoke.check_kernel_times(_kernels_line())
    pairs = dict(chip_smoke.kernel_time_bounds(_kernels_line()[0]))
    assert pairs == {"ms": "bound_ms", "w512_10m_ms": "w512_10m_bound_ms"}
    with pytest.raises(AssertionError, match="bpr_bwd.ms_1024x64 = 0.00355 ms, under"):
        chip_smoke.check_kernel_times(_kernels_line(ms_1024x64=0.00355))
    with pytest.raises(AssertionError, match="bpr_bwd.ms_4096x128: no bound_ms_4096x128"):
        chip_smoke.check_kernel_times(_kernels_line(ms_4096x128=0.9))
    with pytest.raises(AssertionError, match="under its bound"):
        chip_smoke.check_kernel_times(_kernels_line(ms=float("nan")))
    chip_smoke.check_kernel_times(_kernels_line(ms_4096x128=0.9, bound_ms_4096x128=0.38,
                                                plain_ms_4096x128=0.0001))


# ------------------------------------------------------------------ #
# the sweeps phase's checks                                            #
# ------------------------------------------------------------------ #

def test_check_steps_launches_is_exact():
    chip_smoke.check_steps_launches("t", {"bpr_fwd": 7, "bpr_bwd": 7}, 7, True)
    chip_smoke.check_steps_launches("t", {"bpr_fwd": 0, "bpr_bwd": 0}, 7, False)
    for bad in ({"bpr_fwd": 8, "bpr_bwd": 7}, {"bpr_fwd": 7, "bpr_bwd": 6}):
        with pytest.raises(AssertionError, match="launches"):
            chip_smoke.check_steps_launches("t", bad, 7, True)
    with pytest.raises(AssertionError):
        chip_smoke.check_steps_launches("t", {"bpr_fwd": 1, "bpr_bwd": 1}, 7, False)


def _blend_rows():
    return [{"beta": b, "full_ndcg@10": 0.1 + b, "full_recall@20": 0.2, "full_mrr": 0.3,
             "retrieval_only_ndcg@10": 0.05, "retrieval_only_recall@20": 0.12}
            for b in (0.0, 1.0, 2.0)]


def test_check_blend_rows():
    chip_smoke.check_blend_rows(_blend_rows(), [0.0, 1.0, 2.0])
    moved = _blend_rows()
    moved[2]["retrieval_only_recall@20"] = 0.1200001
    with pytest.raises(AssertionError, match="moves with beta"):
        chip_smoke.check_blend_rows(moved, [0.0, 1.0, 2.0])
    nan = _blend_rows()
    nan[1]["full_mrr"] = float("nan")
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke.check_blend_rows(nan, [0.0, 1.0, 2.0])
    with pytest.raises(AssertionError, match="betas"):
        chip_smoke.check_blend_rows(_blend_rows(), [0.0, 1.0])


def test_check_ladder():
    from recommendit_tpu_torch.scripts.ladder_sweep import KEYS

    line = {k: 0.1 for k in KEYS}
    chip_smoke.check_ladder([line, dict(line, agg=True)], KEYS)
    for bad in (float("nan"), float("inf")):
        with pytest.raises(AssertionError, match="not finite"):
            chip_smoke.check_ladder([line, dict(line, mrr=bad)], KEYS)
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke.check_ladder([{k: v for k, v in line.items() if k != "mrr"}], KEYS)


def test_check_tower_row():
    row = {"popularity_ndcg@10": 0.031, "retrieval_ndcg@10": 0.06}
    chip_smoke.check_tower_row(row, 0.031, 0.01)
    with pytest.raises(AssertionError, match="popularity"):
        chip_smoke.check_tower_row(row, 0.031 + 1e-12, 0.01)
    with pytest.raises(AssertionError, match="random"):
        chip_smoke.check_tower_row(row, 0.031, 0.06)


def test_check_headroom():
    from recommendit_tpu_torch.scripts.ranker_headroom import ORDERINGS

    rep = {"ndcg@10": 0.1, "recall@20": 0.2, "mrr": 0.3}
    out = {"M": 1e5, "expected_presents": 1005.0, "realized": 1000,
           "rows": {k: dict(rep) for k in ORDERINGS}}
    chip_smoke.check_headroom(out, ORDERINGS)
    with pytest.raises(AssertionError, match="presents"):
        chip_smoke.check_headroom(dict(out, expected_presents=1011.0), ORDERINGS)
    bad = {k: dict(rep) for k in ORDERINGS}
    bad["oracle"]["ndcg@10"] = float("nan")
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke.check_headroom(dict(out, rows=bad), ORDERINGS)


def test_check_real_data(tmp_path):
    import json

    stages = ("features", "embeddings", "index", "ranker")
    report = {"mode": "golden-fixture", "comparable_to_reference": False,
              "stage_seconds": {s: 0.1 for s in (*stages, "evaluate")},
              "blocked_syscall": "download_movielens: Cannot download MovieLens-1M"}
    out = tmp_path / "REALDATA.json"
    out.write_text(json.dumps(report))
    chip_smoke.check_real_data(report, out, stages)
    with pytest.raises(AssertionError, match="mode"):
        chip_smoke.check_real_data(dict(report, mode="real"), out, stages)
    with pytest.raises(AssertionError, match="no download error"):
        chip_smoke.check_real_data(dict(report, blocked_syscall=None), out, stages)
    short = dict(report, stage_seconds={s: 0.1 for s in stages})
    with pytest.raises(AssertionError, match="stages"):
        chip_smoke.check_real_data(short, out, stages)
    with pytest.raises(AssertionError, match="not written"):
        chip_smoke.check_real_data(report, tmp_path / "missing.json", stages)


def test_phase_start_records_the_host_state(monkeypatch):
    monkeypatch.setattr(chip_smoke, "PHASE_RECORDS", [])
    t0 = chip_smoke.time.perf_counter()
    rec = chip_smoke.phase_start("a phase", t0 - 2.0)
    assert chip_smoke.PHASE_RECORDS == [rec] and rec["phase"] == "a phase"
    assert rec["since_start_s"] >= 2.0
    assert rec["threads"] == sum(rec["thread_names"].values()) >= 1
    assert rec["thread_names"].get("MainThread") == 1
    assert 0 < rec["rss_gib"] <= rec["rss_peak_gib"]
    assert rec["cuda_reserved_gib"] is None or rec["cuda_reserved_gib"] >= 0


def test_the_archive_round_trip_is_checked(tmp_path):
    """``write_ml1m_archive`` lays the files out as GroupLens's archive
    (``ml-1m/<name>``); ``check_download`` passes the extracted copy and
    refuses one changed byte or a zip left beside it."""
    import zipfile

    staged = tmp_path / "dat"
    staged.mkdir()
    for i, name in enumerate(chip_smoke.ML1M_FILES):
        (staged / name).write_bytes(bytes(range(i, i + 50)) * 7)
    archive = chip_smoke.write_ml1m_archive(staged, tmp_path / "archive" / "ml-1m.zip")
    with zipfile.ZipFile(archive) as zf:
        assert sorted(zf.namelist()) == sorted(f"ml-1m/{n}" for n in chip_smoke.ML1M_FILES)
        zf.extractall(tmp_path / "out")
    got = chip_smoke.check_download(staged, tmp_path / "out" / "ml-1m", archive, 0.5)
    assert got["files_equal"] and got["files_bytes"] == 4 * 350
    (tmp_path / "out" / "ml-1m.zip").write_bytes(b"")
    with pytest.raises(AssertionError, match="left beside"):
        chip_smoke.check_download(staged, tmp_path / "out" / "ml-1m", archive, 0.5)
    (tmp_path / "out" / "ml-1m.zip").unlink()
    (tmp_path / "out" / "ml-1m" / "users.dat").write_bytes(b"changed")
    with pytest.raises(AssertionError, match="users.dat"):
        chip_smoke.check_download(staged, tmp_path / "out" / "ml-1m", archive, 0.5)


def test_offline_refuses_a_connect_and_restores_it():
    import socket

    connect = socket.socket.connect

    def dial():
        with socket.socket() as sock:
            sock.connect(("127.0.0.1", 9))

    with pytest.raises(AssertionError, match="offline"):
        chip_smoke.offline(dial)()
    assert socket.socket.connect is connect


def test_dlrm_bags_phase_work_on_the_cpu():
    """The dlrm_bags phase's work at a small shape (plain path on both
    sides): the record it checks, the model's steps counted, and its
    refusals."""
    rec = chip_smoke.dlrm_bags_rank((1, 500, 300, 40), (3, 2, 8, 1), 16, 64, 5, 2, steps=3)
    chip_smoke.check_dlrm_bags(rec, on_card=False)
    assert rec["step_rows_updated"] == 4 * rec["unique_rows"]
    assert rec["hottest_row_hits"] >= 64 * 3
    assert rec["zero"]["once_equal"] and rec["zero"]["rows_once"] > 0
    assert rec["fwd_bound_by"] == "bytes" and rec["update_bound_ms"] > rec["fwd_bound_ms"]
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_dlrm_bags(dict(rec, step_syncs=0), on_card=True)
    with pytest.raises(AssertionError, match="waited for the host"):
        chip_smoke.check_dlrm_bags(dict(rec, step_syncs="a sync",
                                        step_launches={"bag_fwd": 3, "bag_update": 3}),
                                   on_card=True)
    with pytest.raises(AssertionError, match="rows counted"):
        chip_smoke.check_dlrm_bags(dict(rec, step_rows_updated=rec["step_rows_updated"] - 1),
                                   on_card=False)
    with pytest.raises(AssertionError, match="rows one slot names"):
        chip_smoke.check_dlrm_bags(dict(rec, zero=dict(rec["zero"], once_equal=False)),
                                   on_card=False)
    assert chip_smoke.dlrm_rows((70_000, 65_536, 3)) == (17_500, 65_536, 3)
