"""The ML-1M download (``data/movielens.download_movielens`` and
``MOVIELENS_1M_URL``) against JAX's, on a local archive.

Both packages' ``MOVIELENS_1M_URL`` point at a ``file://`` zip built here
from ``tests/fixtures/ml1m_golden`` (its ``ml-1m/`` folder, as the real
archive lays it out), and every socket connect raises: no test reaches the
network. Held: the extracted files byte for byte the fixture's in both, the
zip removed, the same target returned; a second call fetches nothing; a
missing ``file://`` path and an archive without the expected files raise
``RuntimeError`` in both, with JAX's messages.
"""
import socket
import zipfile
from pathlib import Path

import pytest

import recommendit_tpu.data.movielens as jml
import recommendit_tpu_torch.data.movielens as tml

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "ml1m_golden"
FILES = ("ratings.dat", "users.dat", "movies.dat", "README")
PACKAGES = {"jax": jml, "port": tml}


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
