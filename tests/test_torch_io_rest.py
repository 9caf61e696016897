"""The rest of the port's io/ (kaldi_aslp_tpu_torch/io/) against the JAX
package's kaldi_aslp_tpu/io/ on the CPU, from the same numpy-seeded
values: float vectors (written "FV", read "FV" and "DV"), posteriors,
their holders and tables (sequential and random-access readers, writers
to ``ark:``, ``ark,t:`` and ``ark,scp:``), wave and HTK files and Kaldi
data dirs.  Each is written by one package and read by the other, both
ways, binary and text, and the files are byte-equal."""

import io
import os

import numpy as np
import pytest

from kaldi_aslp_tpu import io as jio
from kaldi_aslp_tpu.io import datadir as jdatadir
from kaldi_aslp_tpu.io import kaldi_io as jkio
from kaldi_aslp_tpu_torch import io as pio
from kaldi_aslp_tpu_torch.io import datadir as pdatadir
from kaldi_aslp_tpu_torch.io import kaldi_io as pkio

PACKAGES = {"port": pio, "jax": jio}
PRIMS = {"port": pkio, "jax": jkio}
DIRECTIONS = [("port", "jax"), ("jax", "port")]


def _vectors(seed=0):
    rs = np.random.RandomState(seed)
    return {f"utt{i}": rs.randn(rs.randint(1, 9)).astype(np.float32)
            for i in range(4)}


def _posteriors(seed=0):
    rs = np.random.RandomState(seed)
    return {f"utt{i}": [[(int(rs.randint(0, 50)),
                          float(np.float32(rs.rand())))
                         for _ in range(rs.randint(0, 4))]
                        for _ in range(rs.randint(1, 6))]
            for i in range(4)}


def _same_posterior(got, want):
    assert len(got) == len(want)
    for gf, wf in zip(got, want):
        assert [i for i, _ in gf] == [i for i, _ in wf]
        np.testing.assert_allclose([v for _, v in gf], [v for _, v in wf],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("binary", [True, False])
def test_vector_objects_cross_read(writer, reader, binary):
    vec = _vectors()["utt1"]
    buf = io.BytesIO()
    PRIMS[writer].write_vector(buf, vec, binary)
    other = io.BytesIO()
    PRIMS[reader].write_vector(other, vec, binary)
    assert buf.getvalue() == other.getvalue()
    buf.seek(0)
    got = PRIMS[reader].read_vector(buf, binary)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vec)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_double_vectors_read_as_float32(package):
    """A Vector<double> ("DV ") reads as float32 in both packages."""
    vec = np.random.RandomState(3).randn(7)
    raw = b"DV \x04" + np.int32(7).tobytes() + vec.astype("<f8").tobytes()
    got = PRIMS[package].read_vector(io.BytesIO(raw), True)
    np.testing.assert_array_equal(got, vec.astype(np.float32))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("binary", [True, False])
def test_posterior_objects_cross_read(writer, reader, binary):
    post = _posteriors()["utt2"]
    buf = io.BytesIO()
    PRIMS[writer].write_posterior(buf, post, binary)
    other = io.BytesIO()
    PRIMS[reader].write_posterior(other, post, binary)
    assert buf.getvalue() == other.getvalue()
    buf.seek(0)
    _same_posterior(PRIMS[reader].read_posterior(buf, binary), post)


@pytest.mark.parametrize("binary", [True, False])
def test_basic_float_both_ways(binary):
    for value in (0.0, -1.5, 3.25e-7):
        a, b = io.BytesIO(), io.BytesIO()
        pkio.write_basic_float(a, value)
        jkio.write_basic_float(b, value)
        assert a.getvalue() == b.getvalue()
        a.seek(0)
        assert jkio.read_basic_float(a) == pkio.read_basic_float(
            io.BytesIO(b.getvalue()))


TABLES = {"vector": (_vectors, "vector_writer", "sequential_vector_reader",
                     "random_access_vector_reader"),
          "posterior": (_posteriors, "posterior_writer",
                        "sequential_posterior_reader",
                        "random_access_posterior_reader")}


def _check_value(kind, got, want):
    if kind == "vector":
        np.testing.assert_array_equal(got, want)
    else:
        _same_posterior(got, want)


@pytest.mark.parametrize("kind", sorted(TABLES))
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("flags", ["ark", "ark,t"])
def test_tables_cross_read(tmp_path, kind, writer, reader, flags):
    make, w_name, seq_name, ra_name = TABLES[kind]
    values = make()
    paths = {}
    for pkg in ("port", "jax"):
        ark = str(tmp_path / f"{pkg}.ark")
        scp = str(tmp_path / f"{pkg}.scp")
        with getattr(PACKAGES[pkg], w_name)(
                f"{flags},scp:{ark},{scp}") as w:
            for key, val in values.items():
                w[key] = val
        paths[pkg] = (ark, scp)
    with open(paths["port"][0], "rb") as a, open(paths["jax"][0], "rb") as b:
        assert a.read() == b.read()
    ark, scp = paths[writer]
    rd = PACKAGES[reader]
    for spec in (f"ark:{ark}", f"scp:{scp}", f"ark:cat {ark} |"):
        got = dict(getattr(rd, seq_name)(spec))
        assert sorted(got) == sorted(values)
        for key in values:
            _check_value(kind, got[key], values[key])
    ra = getattr(rd, ra_name)(f"scp:{scp}")
    for key in reversed(sorted(values)):
        assert key in ra
        _check_value(kind, ra[key], values[key])
    assert "missing" not in ra


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_int_vector_and_matrix_readers_cross_read(tmp_path, writer, reader):
    """The sequential int-vector and random-access matrix readers the
    tree tools use, over the other package's files."""
    rs = np.random.RandomState(5)
    alis = {f"u{i}": rs.randint(1, 90, rs.randint(1, 20)).astype(np.int32)
            for i in range(3)}
    mats = {f"u{i}": rs.randn(rs.randint(1, 6), 3).astype(np.float32)
            for i in range(3)}
    w = PACKAGES[writer]
    with w.int_vector_writer(f"ark:{tmp_path}/ali.ark") as out:
        for k, v in alis.items():
            out[k] = v
    with w.matrix_writer(
            f"ark,scp:{tmp_path}/m.ark,{tmp_path}/m.scp") as out:
        for k, v in mats.items():
            out[k] = v
    r = PACKAGES[reader]
    got = dict(r.sequential_int_vector_reader(f"ark:{tmp_path}/ali.ark"))
    for k, v in alis.items():
        np.testing.assert_array_equal(got[k], v)
    ra = r.random_access_matrix_reader(f"scp:{tmp_path}/m.scp")
    for k, v in mats.items():
        np.testing.assert_array_equal(ra[k], v)


def _wave(channels, n, seed=1):
    rs = np.random.RandomState(seed)
    return np.round(rs.randn(channels, n) * 3000).astype(np.float32)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("channels", [1, 2])
def test_wave_files_cross_read(tmp_path, writer, reader, channels):
    data = _wave(channels, 801)
    files = {}
    for pkg in ("port", "jax"):
        p = str(tmp_path / f"{pkg}.wav")
        PACKAGES[pkg].write_wave(p, PACKAGES[pkg].WaveData(8000.0, data))
        files[pkg] = p
    with open(files["port"], "rb") as a, open(files["jax"], "rb") as b:
        assert a.read() == b.read()
    got = PACKAGES[reader].read_wave(files[writer])
    assert got.samp_freq == 8000.0
    assert got.duration == pytest.approx(801 / 8000.0)
    np.testing.assert_array_equal(got.data, data)
    with open(files[writer], "rb") as f:
        np.testing.assert_array_equal(
            PACKAGES[reader].read_wave(f).data, data)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_wave_refuses_what_is_not_a_wave(package):
    with pytest.raises(ValueError, match="RIFF"):
        PACKAGES[package].read_wave(io.BytesIO(b"JUNK" * 4))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_htk_files_cross_read(tmp_path, writer, reader):
    feats = np.random.RandomState(2).randn(11, 13).astype(np.float32)
    files = {}
    for pkg in ("port", "jax"):
        p = str(tmp_path / f"{pkg}.htk")
        PACKAGES[pkg].write_htk(p, feats, sample_period=100000,
                                sample_kind=6)
        files[pkg] = p
    with open(files["port"], "rb") as a, open(files["jax"], "rb") as b:
        assert a.read() == b.read()
    got, hdr = PACKAGES[reader].read_htk(files[writer])
    np.testing.assert_array_equal(got, feats)
    assert (hdr.num_samples, hdr.sample_period, hdr.sample_size,
            hdr.sample_kind) == (11, 100000, 52, 6)


def _fill(pkg_datadir, path):
    d = pkg_datadir.DataDir(path=path)
    for i in range(7):
        u = f"utt{i}"
        d.wav_scp[u] = f"/data/{u}.wav"
        d.text[u] = "YES NO" if i % 2 else "NO"
        d.utt2spk[u] = f"spk{i % 3}"
        d.feats_scp[u] = f"feats.ark:{10 * i}"
        d.segments[u] = (f"rec{i}", 0.5 * i, 0.5 * i + 1.25)
    return d


def _files(path):
    return {n: open(os.path.join(path, n)).read()
            for n in sorted(os.listdir(path))
            if os.path.isfile(os.path.join(path, n))}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_data_dirs_save_load_validate_split(tmp_path, writer, reader):
    mods = {"port": pdatadir, "jax": jdatadir}
    for pkg in ("port", "jax"):
        _fill(mods[pkg], str(tmp_path / pkg)).save()
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    got = mods[reader].DataDir.load(str(tmp_path / writer))
    want = _fill(mods[reader], str(tmp_path / writer))
    for field in ("wav_scp", "text", "utt2spk", "feats_scp", "segments"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.spk2utt() == want.spk2utt()
    assert got.utt_ids() == want.utt_ids()
    assert got.validate() == []
    del got.text["utt3"]
    got.utt2spk["stray"] = "spk0"
    other = mods[writer].DataDir.load(str(tmp_path / writer))
    del other.text["utt3"]
    other.utt2spk["stray"] = "spk0"
    assert got.validate() == other.validate() != []
    shards = mods[reader].split_data_dir(got, 3)
    ref = mods[writer].split_data_dir(other, 3)
    for a, b in zip(shards, ref):
        assert os.path.relpath(a.path, tmp_path) == \
            os.path.relpath(b.path, tmp_path)
        for field in ("wav_scp", "text", "utt2spk", "feats_scp",
                      "segments"):
            assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("package", ["port", "jax"])
def test_write_key_value_sorts_keys(tmp_path, package):
    mod = {"port": pdatadir, "jax": jdatadir}[package]
    p = str(tmp_path / "kv")
    mod.write_key_value(p, {"b": "2 x", "a": "1"})
    assert open(p).read() == "a 1\nb 2 x\n"
    assert pdatadir.read_key_value(p) == jdatadir.read_key_value(p)
