"""The ML-1M download (``data/movielens.download_movielens`` and
``MOVIELENS_1M_URL``) and the pipeline's ``data`` stage, which calls it,
against JAX's, on a local archive.

Both packages' ``MOVIELENS_1M_URL`` point at a ``file://`` zip built here
from ``tests/fixtures/ml1m_golden`` (its ``ml-1m/`` folder, as the real
archive lays it out), and every socket connect raises: no test reaches the
network. Held: the extracted files byte for byte the fixture's in both, the
zip removed, the same target returned; a second call fetches nothing; a
missing ``file://`` path and an archive without the expected files raise
``RuntimeError`` in both, with JAX's messages. The ``data`` stage without
``--synthetic``, through the orchestrator and through the CLI, extracts
into ``<parent of data_dir>/ml-1m`` in both packages, whatever
``data_dir`` is named, and raises the same ``RuntimeError`` in both where
the fetch fails.
"""
import socket
import zipfile
from pathlib import Path

import pytest

import recommendit_tpu.data.movielens as jml
import recommendit_tpu.pipelines.run_pipeline as jrp
import recommendit_tpu_torch.data.movielens as tml
from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.pipelines import run_pipeline as trp

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "ml1m_golden"
FILES = ("ratings.dat", "users.dat", "movies.dat", "README")
PACKAGES = {"jax": jml, "port": tml}
PIPELINES = {"jax": (jrp, JaxSettings, {}), "port": (trp, Settings, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a test tried to open a connection: {args}")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def _zip(path: Path, files=FILES) -> Path:
    with zipfile.ZipFile(path, "w") as zf:
        for name in files:
            zf.write(GOLDEN / name, f"ml-1m/{name}")
    return path


def _point(monkeypatch, url: str) -> None:
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "MOVIELENS_1M_URL", url)


def test_the_url_is_jax_s():
    assert tml.MOVIELENS_1M_URL == jml.MOVIELENS_1M_URL


def test_download_extracts_what_jax_extracts(tmp_path, monkeypatch):
    _point(monkeypatch, _zip(tmp_path / "ml-1m.zip").as_uri())
    got = {name: mod.download_movielens(str(tmp_path / name))
           for name, mod in PACKAGES.items()}
    for name, target in got.items():
        assert Path(target) == tmp_path / name / "ml-1m"
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == ["ml-1m"]
        for f in FILES:
            assert (target / f).read_bytes() == (GOLDEN / f).read_bytes(), (name, f)
    # present now: nothing is fetched, even from an address that answers nothing
    _point(monkeypatch, (tmp_path / "gone.zip").as_uri())
    for name, mod in PACKAGES.items():
        assert mod.download_movielens(str(tmp_path / name)) == got[name]


@pytest.mark.parametrize("name", list(PACKAGES))
def test_a_missing_archive_raises_runtime_error(name, tmp_path, monkeypatch):
    missing = tmp_path / "no-such-ml-1m.zip"
    _point(monkeypatch, missing.as_uri())
    with pytest.raises(RuntimeError, match="synthetic") as err:
        PACKAGES[name].download_movielens(str(tmp_path / "out"))
    assert str(missing) in str(err.value)
    assert not (tmp_path / "out" / "ml-1m").exists()


@pytest.mark.parametrize("name", list(PACKAGES))
def test_an_incomplete_archive_fails_verification(name, tmp_path, monkeypatch):
    _point(monkeypatch, _zip(tmp_path / "short.zip", FILES[:3]).as_uri())
    with pytest.raises(RuntimeError, match="failed verification"):
        PACKAGES[name].download_movielens(str(tmp_path / "out"))
    assert not (tmp_path / "out" / "ml-1m.zip").exists()


def _data_stage(name: str, entry: str, data_dir: Path, monkeypatch) -> None:
    """The ``data`` stage of package ``name``, not synthetic, through its
    orchestrator or its CLI (logging left as it is)."""
    mod, settings, extra = PIPELINES[name]
    if entry == "orchestrator":
        mod.PipelineOrchestrator(cfg=settings(), data_dir=str(data_dir),
                                 models_dir=str(data_dir.parent / "models"),
                                 **extra).run_stage("data")
    else:
        monkeypatch.setattr(mod, "setup_logging", lambda level: None)
        mod.main(["--stage", "data", "--data-dir", str(data_dir),
                  "--models-dir", str(data_dir.parent / "models"),
                  *(["--device", "cpu"] if extra else [])])


@pytest.mark.parametrize("dir_name", ["ml-1m", "ml"])
@pytest.mark.parametrize("entry", ["orchestrator", "cli"])
def test_data_stage_downloads_as_jax(entry, dir_name, tmp_path, monkeypatch):
    """Both packages' ``data`` stage fetch the archive into the parent of
    ``data_dir``: a ``data_dir`` named ``ml-1m`` is the target, one named
    otherwise is left uncreated and the files land beside it."""
    _point(monkeypatch, _zip(tmp_path / "archive.zip").as_uri())
    for name in PIPELINES:
        parent = tmp_path / name
        _data_stage(name, entry, parent / dir_name, monkeypatch)
        assert sorted(p.name for p in parent.iterdir()) == ["ml-1m"], name
        for f in FILES:
            assert (parent / "ml-1m" / f).read_bytes() == (GOLDEN / f).read_bytes(), (
                name, f)
    # the files present: nothing is fetched, even from an address that answers nothing
    _point(monkeypatch, (tmp_path / "gone.zip").as_uri())
    for name in PIPELINES:
        _data_stage(name, entry, tmp_path / name / dir_name, monkeypatch)
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == ["ml-1m"], name


@pytest.mark.parametrize("entry", ["orchestrator", "cli"])
@pytest.mark.parametrize("name", list(PIPELINES))
def test_data_stage_raises_where_the_fetch_fails(name, entry, tmp_path, monkeypatch):
    missing = tmp_path / "no-such-ml-1m.zip"
    _point(monkeypatch, missing.as_uri())
    with pytest.raises(RuntimeError, match="Cannot download MovieLens-1M") as err:
        _data_stage(name, entry, tmp_path / "out" / "ml", monkeypatch)
    assert str(missing) in str(err.value)
    assert not (tmp_path / "out" / "ml-1m").exists()
    assert not (tmp_path / "out" / "ml").exists()
