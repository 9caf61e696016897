"""The port's feature, pitch, spectrum, syllable and noise CLI tools
(kaldi_aslp_tpu_torch/cli/feat_tools.py, vad_tools.py, script_tools.py,
nnet_tools.py's ``aslp-wav-noise``) against the JAX package's tools of
the same names on the CPU, each on the same inputs: a ``wav.scp`` of
five harmonic hard-corpus waves (8 kHz, written as 16-bit wavs) and the
tables and text files the chain makes from them.

Equal bit for bit: copy-feats, splice-feats (copies), feat-to-dim, the
four syllable tools' text and files and aslp-wav-noise's wavs.  Within
``TOL`` of tests/test_torch_mfcc.py: compute-mfcc-feats,
compute-fbank-feats, compute-cmvn-stats, apply-cmvn, add-deltas and
compute-kaldi-pitch-feats; aslp-compute-spectrum-feats as
tests/test_torch_frontend.py holds the spectrogram.  The port's tools run
with ``--device=cpu``; the extractors refuse ``--dither`` other than 0,
where the JAX tools take it and never dither."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.cli.__main__ import main as jax_main
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS, main
from kaldi_aslp_tpu_torch.io import (
    WaveData,
    read_wave,
    sequential_matrix_reader,
    write_wave,
)
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
from kaldi_aslp_tpu_torch.recipes import hkust_synth as hk
from kaldi_aslp_tpu_torch.utils.config import ConfigError
from test_torch_frontend import assert_log_spectra_close
from test_torch_mfcc import TOL, _tiny_set

torch.set_num_threads(1)

NEW_TOOLS = ("compute-mfcc-feats", "compute-fbank-feats", "copy-feats",
             "compute-cmvn-stats", "apply-cmvn", "add-deltas",
             "splice-feats", "feat-to-dim", "compute-kaldi-pitch-feats",
             "aslp-compute-spectrum-feats",
             "aslp-convert-lexicon-to-syllable", "aslp-bind-syllable",
             "aslp-bind-lexicon", "aslp-ali-to-syllable", "aslp-wav-noise")
SR = "--sample-frequency=8000"


@pytest.fixture(scope="module")
def wav_scp(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    waves, _ = _tiny_set(hc, harmonic=True)
    lines = []
    for u in sorted(waves):
        path = str(d / f"{u}.wav")
        write_wave(path, WaveData(8000.0, waves[u][None]))
        lines.append(f"{u} {path}")
    (d / "wav.scp").write_text("\n".join(lines) + "\n")
    return str(d / "wav.scp")


def _read(path):
    return dict(sequential_matrix_reader(f"ark:{path}"))


def _both(tmp_path, tool, args, out_name="out.ark"):
    """Run ``tool`` of both packages on ``args`` (each ending in its own
    output ark): (port's tables, JAX's tables)."""
    got, want = str(tmp_path / f"p_{out_name}"), str(tmp_path / f"j_{out_name}")
    assert main([tool, "--device=cpu", *args, f"ark:{got}"]) == 0
    assert jax_main([tool, *args, f"ark:{want}"]) == 0
    return got, want


def _close(got_path, want_path, check=None):
    got, want = _read(got_path), _read(want_path)
    assert sorted(got) == sorted(want) and got
    for u in want:
        assert got[u].shape == want[u].shape and got[u].dtype == \
            want[u].dtype
        (check or (lambda a, b: np.testing.assert_allclose(a, b, **TOL)))(
            got[u], want[u])
    return got


def test_the_registry_has_the_new_tools():
    # 53 with the feature tools; 70 since the nnet zoo's 17 names; 98
    # since the application layer's 28; 103 since the five MPI workers
    assert set(NEW_TOOLS) <= set(TOOLS) and len(TOOLS) == 103


def test_feature_chain_matches_jax(wav_scp, tmp_path, capsys):
    """compute-mfcc-feats -> compute-cmvn-stats -> apply-cmvn ->
    add-deltas -> splice-feats -> feat-to-dim, plus compute-fbank-feats
    and copy-feats, each tool on the JAX chain's own input."""
    mfcc, mfcc_j = _both(tmp_path, "compute-mfcc-feats",
                         [SR, "--num-ceps=12", f"scp:{wav_scp}"], "mfcc.ark")
    _close(mfcc, mfcc_j)
    fb, fb_j = _both(tmp_path, "compute-fbank-feats",
                     [SR, "--num-mel-bins=20", "--window-type=hamming",
                      f"scp:{wav_scp}"], "fbank.ark")
    _close(fb, fb_j)
    u2s = tmp_path / "utt2spk"
    spk2utt = tmp_path / "spk2utt"
    utts = sorted(_read(mfcc_j))
    u2s.write_text("".join(f"{u} s{i % 2}\n" for i, u in enumerate(utts)))
    spk2utt.write_text("".join(
        f"s{k} " + " ".join(u for i, u in enumerate(utts) if i % 2 == k)
        + "\n" for k in (0, 1)))
    st, st_j = _both(tmp_path, "compute-cmvn-stats",
                     [f"--spk2utt={spk2utt}", f"ark:{mfcc_j}"], "cmvn.ark")
    stats = _close(st, st_j)
    assert sorted(stats) == ["s0", "s1"]
    for norm in ("false", "true"):
        cm, cm_j = _both(tmp_path, "apply-cmvn",
                         [f"--norm-vars={norm}", f"--utt2spk={u2s}",
                          f"ark:{st_j}", f"ark:{mfcc_j}"], f"cmn{norm}.ark")
        _close(cm, cm_j)
    de, de_j = _both(tmp_path, "add-deltas", ["--delta-order=2",
                                              f"ark:{cm_j}"], "deltas.ark")
    assert _close(de, de_j)[utts[0]].shape[1] == 36
    sp, sp_j = _both(tmp_path, "splice-feats",
                     ["--left-context=2", "--right-context=1",
                      f"ark:{de_j}"], "splice.ark")
    _close(sp, sp_j, np.testing.assert_array_equal)
    cp, cp_j = _both(tmp_path, "copy-feats", [f"ark:{st_j}"], "copy.ark")
    with open(cp, "rb") as a, open(cp_j, "rb") as b:
        assert a.read() == b.read()
    capsys.readouterr()
    assert main(["feat-to-dim", "--device=cpu", f"ark:{sp_j}"]) == 0
    assert jax_main(["feat-to-dim", f"ark:{sp_j}"]) == 0
    assert capsys.readouterr().out == "144\n144\n"


@pytest.mark.parametrize("post", ["true", "false"])
def test_pitch_tool_matches_jax(wav_scp, tmp_path, post):
    got, want = _both(tmp_path, "compute-kaldi-pitch-feats",
                      [f"--post-process={post}", f"scp:{wav_scp}"])
    assert _close(got, want)[sorted(_read(want))[0]].shape[1] == (
        3 if post == "true" else 2)


def test_spectrum_tool_matches_jax(wav_scp, tmp_path):
    got, want = _both(tmp_path, "aslp-compute-spectrum-feats",
                      [f"scp:{wav_scp}"])
    _close(got, want, assert_log_spectra_close)


@pytest.mark.parametrize("tool", ["compute-mfcc-feats", "compute-fbank-feats",
                                  "aslp-compute-spectrum-feats"])
def test_extractors_refuse_dither(wav_scp, tmp_path, tool):
    """The JAX tools take --dither (default 1.0) and never dither; the
    port's refuse any value but 0, with a message that says why."""
    with pytest.raises(ConfigError, match="never dithers"):
        main([tool, "--device=cpu", "--dither=1.0", f"scp:{wav_scp}",
              f"ark:{tmp_path / 'x.ark'}"])
    assert not (tmp_path / "x.ark").exists()
    assert main([tool, "--device=cpu", "--dither=0", f"scp:{wav_scp}",
                 f"ark:{tmp_path / 'y.ark'}"]) == 0


def test_tools_default_to_the_card(wav_scp, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["compute-mfcc-feats", f"scp:{wav_scp}"],
                 ["compute-kaldi-pitch-feats", f"scp:{wav_scp}"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*argv, f"ark:{tmp_path / 'z.ark'}"])


def test_syllable_tools_match_jax(tmp_path, capsys, monkeypatch):
    """The four syllable tools on the pinyin lexicon: the same files and
    the same text on stdout and stderr."""
    lex = tmp_path / "lexicon.txt"
    lex.write_text("".join(
        ln + "\n" for ln in hk.make_pinyin_lexicon(80).splitlines()
        if not ln.startswith("<SIL>")))
    outs = {}
    for name, run in (("port", main), ("jax", jax_main)):
        d = tmp_path / name
        d.mkdir()
        capsys.readouterr()
        assert run(["aslp-convert-lexicon-to-syllable", str(lex),
                    str(d / "syl.txt")]) == 0
        table = capsys.readouterr().out
        rows = [ln.split() for ln in (d / "syl.txt").read_text().splitlines()]
        counts = {}
        for r in rows:
            for i, s in enumerate(r[1:]):
                counts[s] = counts.get(s, 0) + 1 + 3 * (i == 0)
        (d / "counts.txt").write_text("".join(
            f"{s} {c}\n" for s, c in counts.items()) + "zz9 1\n")
        assert run(["aslp-bind-syllable", "--thresh=3",
                    str(d / "counts.txt")]) == 0
        cap = capsys.readouterr()
        bind = cap.out
        (d / "bind.info").write_text("".join(
            " ".join(ln.split()[:2]) + "\n" for ln in bind.splitlines()))
        assert run(["aslp-bind-lexicon", str(d / "bind.info"),
                    str(d / "syl.txt")]) == 0
        bound = capsys.readouterr().out
        phones = sorted({p for ln in lex.read_text().splitlines()
                         for p in ln.split()[1:]})
        (d / "phones.txt").write_text("".join(
            f"{p} {i + 1}\n" for i, p in enumerate(phones)))
        sylls = sorted(set(table.split()[::1]) & set(counts))
        (d / "sylls.txt").write_text("".join(
            f"{s} {i + 1}\n" for i, s in enumerate(sylls)))
        pid = {p: i + 1 for i, p in enumerate(phones)}
        ali = []
        for r in [ln.split() for ln in lex.read_text().splitlines()][:6]:
            for k, p in enumerate(r[1:]):
                ali += [pid[p]] * (1 + k % 3)
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            "utt1 " + " ".join(map(str, ali)) + "\n\nutt2 "
            + " ".join(map(str, ali[:7])) + "\n"))
        assert run(["aslp-ali-to-syllable", str(d / "phones.txt"),
                    str(d / "sylls.txt"), str(d / "bind.info")]) == 0
        outs[name] = (table, (d / "syl.txt").read_text(), bind, cap.err,
                      bound, capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert "Not bind" in outs["port"][3] and "False" in outs["port"][2]


def test_wav_noise_matches_jax(wav_scp, tmp_path):
    for name, run in (("port", main), ("jax", jax_main)):
        assert run(["aslp-wav-noise", "--snr-db=12", "--seed=5",
                    f"scp:{wav_scp}", str(tmp_path / name)]) == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 5
    for f in files:
        with open(tmp_path / "port" / f, "rb") as a, \
                open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read()
    noisy = read_wave(str(tmp_path / "port" / files[0]))
    assert noisy.samp_freq == 8000.0
