"""The port's yesno recipe (kaldi_aslp_tpu_torch/recipes/yesno.py) and its
data-dir runner (recipes/corpus.py) against the JAX package on the CPU:

  * yesno: the synthesized wave files byte-equal, the data dirs' files
    equal, the task inputs (the built-in fallback, or the reference
    checkout's files), and the WER of a whole run equal to JAX's;
  * corpus: ``extract_features`` (fbank + per-speaker CMVN) equal to
    JAX's within rtol = atol = 1e-4 (tests/test_torch_feats.py's
    tolerance); ``run_corpus`` gives a WER through both pipelines,
    ``--dither`` dithers, from the CLI too."""

import os

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.recipes.corpus as jcorpus
import kaldi_aslp_tpu.recipes.yesno as jyesno
from kaldi_aslp_tpu.io import DataDir as JaxDataDir
from kaldi_aslp_tpu_torch.io import DataDir, WaveData, write_wave
from kaldi_aslp_tpu_torch.recipes import corpus, yesno
from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hybrid import HybridRecipeOptions

torch.set_num_threads(1)

FEAT_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_feats.py's
NUM_UTTS = 12


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_yesno_corpus_and_data_dirs_equal_jax(tmp_path):
    texts = yesno.synthesize_corpus(str(tmp_path / "p" / "w"), NUM_UTTS)
    jtexts = jyesno.synthesize_corpus(str(tmp_path / "j" / "w"), NUM_UTTS)
    assert texts == jtexts and len(texts) == NUM_UTTS
    assert _files(str(tmp_path / "p" / "w")) == \
        _files(str(tmp_path / "j" / "w"))
    dirs = yesno.prepare_data(str(tmp_path / "p"), texts,
                              str(tmp_path / "w"))
    jdirs = jyesno.prepare_data(str(tmp_path / "j"), texts,
                                str(tmp_path / "w"))
    assert sorted(dirs) == sorted(jdirs) == ["test_yesno", "train_yesno"]
    assert _files(str(tmp_path / "p" / "data")) == \
        _files(str(tmp_path / "j" / "data"))


def test_task_inputs_fallback_and_reference_files(tmp_path, monkeypatch):
    monkeypatch.delenv(yesno.REFERENCE_ENV, raising=False)
    assert yesno.load_task_inputs() == (jyesno.FALLBACK_LEXICON,
                                        jyesno.FALLBACK_ARPA)
    # a relative lexicon.txt in the working directory is not taken
    monkeypatch.chdir(tmp_path)
    (tmp_path / "lexicon.txt").write_text("YES Y\n")
    assert yesno.load_task_inputs()[0] == jyesno.FALLBACK_LEXICON
    ref = tmp_path / "reference"
    task = ref / "egs" / "yesno" / "s5" / "input"
    task.mkdir(parents=True)
    (task / "lexicon.txt").write_text("<SIL> SIL\nYES Y\nNO N\nMAYBE M\n")
    monkeypatch.setenv(yesno.REFERENCE_ENV, str(ref))
    lex, arpa = yesno.load_task_inputs()
    assert lex.endswith("MAYBE M\n") and arpa == jyesno.FALLBACK_ARPA
    (task / "task.arpabo").write_text(jyesno.FALLBACK_ARPA + "\n")
    assert yesno.load_task_inputs()[1] == jyesno.FALLBACK_ARPA + "\n"


def test_yesno_wer_equals_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(yesno.REFERENCE_ENV, raising=False)
    wer = yesno.run(str(tmp_path / "p"), num_utts=NUM_UTTS, device="cpu")
    jwer = jyesno.run(str(tmp_path / "j"), num_utts=NUM_UTTS)
    assert wer == jwer
    assert "%WER" in capsys.readouterr().out
    art = yesno.run.artifacts
    assert sorted(art["hyps"]) == sorted(art["test_feats"])
    assert os.path.getsize(str(tmp_path / "p" / "lat.ark")) > 0


def _make_corpus(root, rng, num_utts, words_per_utt=3):
    """tests/test_corpus_recipe.py:_make_corpus, written by the port."""
    tones = {"YES": (250.0, 1800.0), "NO": (140.0, 700.0)}
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    d = DataDir(path=os.path.join(root, "data"))
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO")
                 for _ in range(words_per_utt)]
        chunks = [np.zeros(int(0.15 * 8000))]
        for w in words:
            f0, f1 = tones[w]
            t = np.arange(int(0.25 * 8000)) / 8000
            chunks.append(np.hanning(len(t)) * (
                4000 * np.sin(2 * np.pi * f0 * t)
                + 2000 * np.sin(2 * np.pi * f1 * t)))
            chunks.append(np.zeros(int(0.12 * 8000)))
        wave = np.concatenate(chunks) + 20 * rng.randn(
            sum(len(c) for c in chunks))
        path = os.path.join(wav_dir, f"u{u}.wav")
        write_wave(path, WaveData(8000.0, wave[None, :].astype(np.float32)))
        d.wav_scp[f"u{u}"] = path
        d.text[f"u{u}"] = " ".join(words)
        d.utt2spk[f"u{u}"] = f"spk{u % 2}"
    d.save()
    return d.path


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(777)
    train = _make_corpus(str(root / "train"), rng, 16)
    test = _make_corpus(str(root / "test"), rng, 4)
    lexicon = root / "lexicon.txt"
    lexicon.write_text("YES Y\nNO N\n<SIL> SIL\n")
    return train, test, str(lexicon)


@pytest.mark.parametrize("norm_vars,max_utts", [(True, 0), (False, 5)])
def test_extract_features_matches_jax(data_dirs, norm_vars, max_utts):
    train, _, _ = data_dirs
    kw = dict(num_mel_bins=23, norm_vars=norm_vars, max_utts=max_utts)
    got = corpus.extract_features(
        DataDir.load(train), corpus.CorpusRecipeOptions(device="cpu", **kw))
    want = jcorpus.extract_features(JaxDataDir.load(train),
                                    jcorpus.CorpusRecipeOptions(**kw))
    assert sorted(got) == sorted(want)
    assert len(got) == (max_utts or 16)
    for u in want:
        assert got[u].dtype == np.float32 and got[u].shape == want[u].shape
        np.testing.assert_allclose(got[u], want[u], err_msg=u, **FEAT_TOL)


def test_dither_is_refused_not_ignored(data_dirs):
    """JAX's runner takes --dither and never dithers; the port's refuses
    any value but 0."""
    train, _, _ = data_dirs
    d = DataDir.load(train)
    with pytest.raises(ValueError, match="--dither=1.0"):
        corpus.extract_features(d, corpus.CorpusRecipeOptions(
            device="cpu", num_mel_bins=23, dither=1.0, max_utts=2))


@pytest.mark.parametrize("pipeline", ["hybrid", "ctc"])
def test_run_corpus_pipelines_give_a_wer(data_dirs, tmp_path, pipeline):
    train, test, lexicon = data_dirs
    pipeline_opts = {
        "hybrid": HybridRecipeOptions(hidden_dim=16, num_layers=1,
                                      max_iters=2, mono_iters=3,
                                      mono_totgauss=20),
        "ctc": CtcRecipeOptions(model_type="blstm", hidden_dim=8,
                                num_layers=1, max_iters=2, num_streams=4),
    }[pipeline]
    stats = corpus.run_corpus(
        train, test, str(tmp_path / "exp"),
        corpus.CorpusRecipeOptions(pipeline=pipeline, lexicon=lexicon,
                                   num_mel_bins=23, device="cpu"),
        pipeline_opts=pipeline_opts)
    assert stats.ref_length == 12 and np.isfinite(stats.wer)
    assert corpus.run_corpus.recipe.device.type == "cpu"


def test_main_runs_the_hybrid_pipeline(data_dirs, tmp_path, capsys):
    train, test, lexicon = data_dirs
    rc = corpus.main(["--pipeline=hybrid", f"--lexicon={lexicon}",
                      "--num-mel-bins=23", "--device=cpu", train, test,
                      str(tmp_path / "exp")])
    assert rc in (0, 1) and "%WER" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown pipeline"):
        corpus.run_corpus(train, test, str(tmp_path / "x"),
                          corpus.CorpusRecipeOptions(
                              pipeline="gmm", lexicon=lexicon,
                              num_mel_bins=23, device="cpu"))
