"""The application layer's 28 CLI names in the port
(kaldi_aslp_tpu_torch/cli/fst_tools.py, vad_tools.py, script_tools.py)
against the JAX package's tools on the same inputs: stdout equal and the
tables they write equal (integer tables and text files byte for byte;
the GMM files within 1e-4 relative, JAX's EM being float32 and the
port's float64: 3e-3, and the data's average log-likelihood within
1e-4).  Tensor tools run with ``--device=cpu``.  Also: the
port's registry lacked exactly the five MPI workers of distributed
training until they landed and now equals JAX's, the fst tools name a
symbolic label, and the state-map tool refuses a JAX pickle."""

import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.cli.__main__ import TOOLS as JAX_TOOLS, main as jax_main
from kaldi_aslp_tpu.hmm import HmmTopology as JTopo
from kaldi_aslp_tpu.hmm import TransitionModel as JTm
from kaldi_aslp_tpu.models.losses import LossReporter as JReporter
from kaldi_aslp_tpu.tree.build_tree import build_tree as j_build_tree
from kaldi_aslp_tpu.tree.cluster import GaussStats as JStats
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS, main
from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.gmm import global_gmm as pglobal
from kaldi_aslp_tpu_torch.hmm import HmmTopology, TransitionModel
from kaldi_aslp_tpu_torch.io import (
    WaveData,
    int_vector_writer,
    matrix_writer,
    sequential_int_vector_reader,
    sequential_matrix_reader,
    write_wave,
)
from kaldi_aslp_tpu_torch.models.losses import LossReporter
from kaldi_aslp_tpu_torch.recipes import vad as vad_recipe
from kaldi_aslp_tpu_torch.tree.build_tree import build_tree
from kaldi_aslp_tpu_torch.tree.cluster import GaussStats

torch.set_num_threads(1)

CPU = "--device=cpu"
# JAX's EM runs its E-step in float32, the port's in float64; over a few
# EM iterations on fbank features JAX's parameters drift from the port's
# by up to 1.3e-3 relative (the variances), while the data's average
# log-likelihood under either model agrees within 2e-5
GMM_PARAM_TOL, GMM_LL_TOL = 3e-3, 1e-4
NEW_TOOLS = {
    "fst": ["aslp-fst-init", "aslp-fst-info", "aslp-fst-to-dot",
            "aslp-kws-score", "aslp-kws-gen-state-map",
            "aslp-kws-convert-phone-ali", "aslp-kws-evaluation-roc"],
    "vad": ["aslp-apply-energy-vad", "aslp-apply-gmm-vad",
            "aslp-apply-nn-vad", "aslp-apply-nn-vad-frame",
            "aslp-apply-nnet-vad", "aslp-apply-nn-vad-segment",
            "aslp-ali-to-sil", "aslp-select-frames", "aslp-eval-vad",
            "aslp-eval-energy-vad", "aslp-eval-nn-vad", "aslp-eval-gmm-vad",
            "aslp-eval-vad-boundary", "aslp-eval-nn-vad-boundary",
            "gmm-global-init-from-feats"],
    "script": ["aslp-gen-textgrid", "aslp-kws-gen-text-fst",
               "aslp-kws-generate-simulation-ali", "aslp-log-analyse",
               "aslp-log-analyse-ctc", "aslp-mpi-log-analyse"],
}
MPI_WORKERS = {"aslp-nnet-train-frame-worker",
               "aslp-nnet-train-lc-blstm-streams-worker",
               "aslp-nnet-train-lstm-stream-worker",
               "aslp-nnet-train-server", "aslp-nnet-train-simple-mpi"}


def test_registry_lacks_only_the_mpi_workers():
    names = [n for group in NEW_TOOLS.values() for n in group]
    assert len(names) == len(set(names)) == 28
    assert set(names) <= set(TOOLS)
    # the MPI workers were the last five names missing; the registries
    # are now equal
    assert MPI_WORKERS <= set(TOOLS)
    assert set(TOOLS) == set(JAX_TOOLS)
    assert len(TOOLS) == 103 and len(JAX_TOOLS) == 103
    for name in names:
        assert TOOLS[name].__name__ == JAX_TOOLS[name].__name__, name


def both(capsys, name, jax_args, port_args, rc=0):
    """Run JAX's tool and the port's; their stdouts (asserted equal)."""
    assert jax_main([name] + jax_args) == rc
    want = capsys.readouterr().out
    assert main([name] + port_args) == rc
    got = capsys.readouterr().out
    assert got == want, name
    return got


def ints(path):
    return dict(sequential_int_vector_reader(f"ark:{path}"))


def mats(path):
    return dict(sequential_matrix_reader(f"ark:{path}"))


def assert_int_tables_equal(a, b):
    ta, tb = ints(a), ints(b)
    assert list(ta) == list(tb) and ta
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three utterances of the VAD recipe's corpus: waves, fbank, 0/1
    frame labels, noisy sil/speech posteriors and scores, alignments."""
    d = tmp_path_factory.mktemp("app_cli")
    waves, labels = vad_recipe.synthesize(3, seed=5)
    fbank = Fbank(FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
                  device="cpu")
    rs = np.random.RandomState(0)
    lines = []
    with matrix_writer(f"ark:{d / 'feats.ark'}") as fw, \
            int_vector_writer(f"ark:{d / 'ref.ark'}") as lw, \
            matrix_writer(f"ark:{d / 'post.ark'}") as pw, \
            matrix_writer(f"ark:{d / 'scores.ark'}") as sw, \
            int_vector_writer(f"ark:{d / 'ali.ark'}") as aw:
        for i, (w, lab) in enumerate(zip(waves, labels)):
            utt = f"u{i}"
            path = str(d / f"{utt}.wav")
            write_wave(path, WaveData(8000.0, w[None]))
            lines.append(f"{utt} {path}")
            f = fbank(w).numpy()
            n = min(len(f), len(lab))
            fw[utt] = f[:n]
            lw[utt] = lab[:n]
            speech = np.clip(lab[:n] * 0.8 + 0.1 + 0.3 * rs.randn(n),
                             0.01, 0.99).astype(np.float32)
            pw[utt] = np.stack([1 - speech, speech], 1)
            sw[utt] = speech[:, None]
            aw[utt] = np.where(lab[:n] > 0, rs.randint(1, 5, n),
                               rs.randint(0, 1, n)).astype(np.int32)
    (d / "wav.scp").write_text("\n".join(lines) + "\n")
    return d


# -- fst and KWS tools --------------------------------------------------------

def test_fst_init_info_to_dot_match_jax(tmp_path, capsys):
    topo = tmp_path / "topo.txt"
    topo.write_text("0 1 1 10 0.5\n1 2 2 20\n1 1 0 0 0.25\n2\n3 0 3 30\n"
                    "3 1.5\n")
    both(capsys, "aslp-fst-init", [str(topo), str(tmp_path / "j.txt")],
         [str(topo), str(tmp_path / "t.txt")])
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "t.txt").read_bytes()
    info = both(capsys, "aslp-fst-info", [str(tmp_path / "j.txt")],
                [str(tmp_path / "t.txt")])
    assert "num-states 4" in info and "num-eps-input-arcs 1" in info
    dot = both(capsys, "aslp-fst-to-dot", [str(topo)], [str(topo)])
    assert '1:10/0.5' in dot
    both(capsys, "aslp-fst-to-dot", [str(topo), str(tmp_path / "j.dot")],
         [str(topo), str(tmp_path / "t.dot")])
    assert (tmp_path / "j.dot").read_bytes() == \
        (tmp_path / "t.dot").read_bytes()


def test_fst_tools_name_a_symbolic_label(tmp_path):
    """JAX's tools fail on aslp-kws-gen-text-fst's output with int()'s bare
    error; the port's name the symbol (ROADMAP queue 3)."""
    kw = tmp_path / "kw.txt"
    kw.write_text("niho ee ii oo\n")
    fst = str(tmp_path / "kw.fst.txt")
    assert main(["aslp-kws-gen-text-fst", str(kw), fst]) == 0
    for tool in ("aslp-fst-init", "aslp-fst-info", "aslp-fst-to-dot"):
        args = [fst, str(tmp_path / "o.txt")][:2 if tool != "aslp-fst-info"
                                               else 1]
        with pytest.raises(ValueError, match="invalid literal"):
            jax_main([tool] + args)
        with pytest.raises(ValueError, match="symbol 'sil'"):
            main([tool] + args)


def test_kws_score_matches_jax(tmp_path, capsys):
    rs = np.random.RandomState(1)
    path = tmp_path / "post.ark"
    with matrix_writer(f"ark:{path}") as w:
        for u in range(4):
            post = rs.dirichlet(np.full(6, 0.4), size=50).astype(np.float32)
            post[10 + u:20, 2] += 2.0
            post[20:30 - u, 3] += 2.0
            w[f"utt{u}"] = post / post.sum(1, keepdims=True)
    for flags in (["--keywords=hello:2,3;bye:4,5"],
                  ["--keywords=hello:2,3", "--confidence-threshold=0.1"]):
        out = both(capsys, "aslp-kws-score", flags + [f"ark:{path}"],
                   flags + [f"ark:{path}"])
        assert "utt0 hello" in out


PHONES = {"sil": 1, "a": 2, "b": 3}


def _tm_tree(build, Stats, Topo, Tm):
    rs = np.random.RandomState(0)
    stats = {}
    for ph in PHONES.values():
        for pc in range(3):
            for left in (0, 1, 2, 3):
                stats[((left, ph, 0), pc)] = Stats.from_frames(
                    rs.randn(40, 2) + 3 * ph + pc + 4.0 * (left == 2))
    ids = list(PHONES.values())
    tree = build(stats, ids, {p: 3 for p in ids}, min_gain=1.0)
    triples = sorted({(p, s, tree.compute((l, p, r), s)) for p in ids
                      for s in range(3) for l in [0] + ids
                      for r in [0] + ids})
    return Tm(Topo.default(ids), triples=triples), tree


def test_kws_gen_state_map_matches_jax(tmp_path, capsys):
    (tmp_path / "phones.txt").write_text(
        "<eps> 0\nsil 1\na 2\nb 3\n#0 4\n")
    (tmp_path / "kw.lex").write_text("ab a b\naba a b a\n\n")
    for tag, pkg in (("j", (j_build_tree, JStats, JTopo, JTm)),
                     ("t", (build_tree, GaussStats, HmmTopology,
                            TransitionModel))):
        tm, tree = _tm_tree(*pkg)
        pickle.dump(tm, open(tmp_path / f"{tag}.mdl", "wb"))
        pickle.dump(tree, open(tmp_path / f"{tag}.tree", "wb"))
    common = [str(tmp_path / "phones.txt"), str(tmp_path / "kw.lex")]
    both(capsys, "aslp-kws-gen-state-map",
         common + [str(tmp_path / f"j.{x}") for x in
                   ("mdl", "tree", "map", "states")],
         common + [str(tmp_path / f"t.{x}") for x in
                   ("mdl", "tree", "map", "states")])
    for x in ("map", "states"):
        assert (tmp_path / f"j.{x}").read_bytes() == \
            (tmp_path / f"t.{x}").read_bytes()
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        main(["aslp-kws-gen-state-map"] + common + [
            str(tmp_path / "j.mdl"), str(tmp_path / "t.tree"),
            str(tmp_path / "x.map"), str(tmp_path / "x.states")])


def test_kws_convert_phone_ali_matches_jax(tmp_path, capsys, data):
    pm = tmp_path / "phone.map"
    pm.write_text("1 7\n2 7\n3 8\n4 9\n5 9\n")
    ali = tmp_path / "ali.ark"
    with int_vector_writer(f"ark:{ali}") as w:
        for u, a in ints(data / "ali.ark").items():
            w[u] = a + 1
    both(capsys, "aslp-kws-convert-phone-ali",
         [str(pm), f"ark:{ali}", f"ark:{tmp_path / 'j.ark'}"],
         [str(pm), f"ark:{ali}", f"ark:{tmp_path / 't.ark'}"])
    assert_int_tables_equal(tmp_path / "j.ark", tmp_path / "t.ark")
    assert sorted(np.unique(np.concatenate(list(
        ints(tmp_path / "t.ark").values())))) == [7, 8, 9]


def test_kws_evaluation_roc_matches_jax(tmp_path, capsys):
    rs = np.random.RandomState(2)
    keys = [f"u{i}" for i in range(30)]
    (tmp_path / "score.txt").write_text("".join(
        f"{k} [ {rs.rand():.3f} {rs.rand():.3f} ]\n" for k in keys) + "x\n")
    (tmp_path / "label.txt").write_text("".join(
        f"{k} {int(rs.rand() < 0.5)}\n" for k in keys))
    args = [str(tmp_path / "score.txt"), str(tmp_path / "label.txt")]
    out = both(capsys, "aslp-kws-evaluation-roc", args, args)
    assert out.count("thresh") == 20
    both(capsys, "aslp-kws-evaluation-roc", ["--stride=0.1"] + args,
         ["--stride=0.1"] + args)


# -- VAD tools ----------------------------------------------------------------

def test_apply_energy_vad_matches_jax(data, tmp_path, capsys):
    for flags in ([], ["--energy-threshold=14.5", "--frame-length-ms=20"]):
        both(capsys, "aslp-apply-energy-vad",
             flags + [f"scp:{data / 'wav.scp'}", f"ark:{tmp_path / 'j.ark'}"],
             [CPU] + flags + [f"scp:{data / 'wav.scp'}",
                              f"ark:{tmp_path / 't.ark'}"])
        assert_int_tables_equal(tmp_path / "j.ark", tmp_path / "t.ark")


@pytest.mark.parametrize("name", ["aslp-apply-nn-vad",
                                  "aslp-apply-nn-vad-frame",
                                  "aslp-apply-nnet-vad"])
def test_apply_nn_vad_matches_jax(name, data, tmp_path, capsys):
    flags = ["--sil-posterior-threshold=0.4", "--speech-trigger-ms=30"]
    both(capsys, name,
         flags + [f"ark:{data / 'post.ark'}", f"ark:{tmp_path / 'j.ark'}"],
         flags + [f"ark:{data / 'post.ark'}", f"ark:{tmp_path / 't.ark'}"])
    assert_int_tables_equal(tmp_path / "j.ark", tmp_path / "t.ark")


def test_apply_nn_vad_segment_matches_jax(data, tmp_path, capsys):
    both(capsys, "aslp-apply-nn-vad-segment",
         [f"ark:{data / 'post.ark'}", str(tmp_path / "j.seg")],
         [f"ark:{data / 'post.ark'}", str(tmp_path / "t.seg")])
    text = (tmp_path / "t.seg").read_bytes()
    assert text == (tmp_path / "j.seg").read_bytes() and text


def test_ali_to_sil_and_select_frames_match_jax(data, tmp_path, capsys):
    both(capsys, "aslp-ali-to-sil",
         ["--sil-pdfs=0:3", f"ark:{data / 'ali.ark'}",
          f"ark:{tmp_path / 'j.ark'}"],
         ["--sil-pdfs=0:3", f"ark:{data / 'ali.ark'}",
          f"ark:{tmp_path / 't.ark'}"])
    assert_int_tables_equal(tmp_path / "j.ark", tmp_path / "t.ark")
    both(capsys, "aslp-select-frames",
         [f"ark:{data / 'feats.ark'}", f"ark:{data / 'ref.ark'}",
          f"ark:{tmp_path / 'j.feats'}"],
         [f"ark:{data / 'feats.ark'}", f"ark:{data / 'ref.ark'}",
          f"ark:{tmp_path / 't.feats'}"])
    assert (tmp_path / "j.feats").read_bytes() == \
        (tmp_path / "t.feats").read_bytes()


@pytest.mark.parametrize("name", ["aslp-eval-vad", "aslp-eval-energy-vad",
                                  "aslp-eval-nn-vad"])
def test_eval_vad_matches_jax(name, data, tmp_path, capsys):
    hyp = tmp_path / "hyp.ark"
    assert main(["aslp-apply-nn-vad", f"ark:{data / 'post.ark'}",
                 f"ark:{hyp}"]) == 0
    args = [f"ark:{hyp}", f"ark:{data / 'ref.ark'}"]
    assert both(capsys, name, args, args).startswith("frames ")
    out = both(capsys, name, args + [f"ark:{data / 'scores.ark'}"],
               args + [f"ark:{data / 'scores.ark'}"])
    assert "AUC" in out and "EER" in out


@pytest.mark.parametrize("name", ["aslp-eval-vad-boundary",
                                  "aslp-eval-nn-vad-boundary"])
def test_eval_vad_boundary_matches_jax(name, data, tmp_path, capsys):
    hyp = tmp_path / "hyp.ark"
    lab = tmp_path / "lab.ark"
    rs = np.random.RandomState(4)
    with int_vector_writer(f"ark:{hyp}") as hw, \
            int_vector_writer(f"ark:{lab}") as lw:
        for u in range(5):
            n = 80
            label = np.zeros(n, np.int32)
            label[20 + u:60 - u] = 1
            lw[f"u{u}"] = label
            h = np.roll(label, u - 2)
            h[rs.rand(n) < 0.05] ^= 1
            if u != 3:
                hw[f"u{u}"] = h
        lw["u5"] = np.ones(10, np.int32)
        hw["u5"] = np.ones(10, np.int32)
    for flags in ([], ["--context=4"]):
        out = both(capsys, name, flags + [f"ark:{lab}", f"ark:{hyp}"],
                   flags + [f"ark:{lab}", f"ark:{hyp}"])
        assert "Done 4 files; 2 with errors." in out


@pytest.fixture(scope="module")
def gmms(data, tmp_path_factory):
    """sil / speech features split by aslp-select-frames, and each
    package's global GMMs trained on them."""
    d = tmp_path_factory.mktemp("gmms")
    inv = d / "inv.ark"
    with int_vector_writer(f"ark:{inv}") as w:
        for u, m in ints(data / "ref.ark").items():
            w[u] = 1 - m
    for cls, mask in (("speech", data / "ref.ark"), ("sil", inv)):
        assert main(["aslp-select-frames", f"ark:{data / 'feats.ark'}",
                     f"ark:{mask}", f"ark:{d / cls}.ark"]) == 0
    return d


@pytest.mark.parametrize("flags", [["--num-gauss=4", "--num-iters=6"],
                                   ["--num-gauss=6", "--num-gauss-init=2",
                                    "--num-iters=4", "--seed=3"]])
def test_gmm_global_init_from_feats_matches_jax(gmms, tmp_path, capsys,
                                                flags):
    for cls in ("sil", "speech"):
        both(capsys, "gmm-global-init-from-feats",
             flags + [f"ark:{gmms / cls}.ark", str(tmp_path / f"j{cls}.npz")],
             [CPU] + flags + [f"ark:{gmms / cls}.ark",
                              str(tmp_path / f"t{cls}.npz")])
        got, want = (np.load(tmp_path / f"{t}{cls}.npz") for t in "tj")
        assert sorted(got.files) == sorted(want.files) == \
            ["means", "vars", "weights"]
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == \
                want[k].dtype
            err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= GMM_PARAM_TOL, (cls, k, err)
        feats = np.concatenate(list(mats(f"{gmms / cls}.ark").values()))
        ll = [pglobal.avg_loglike(pglobal.GlobalGmm.load(
            str(tmp_path / f"{t}{cls}.npz")), feats, "cpu") for t in "tj"]
        assert abs(ll[0] - ll[1]) <= GMM_LL_TOL * abs(ll[1])


def _train_gmms(gmms, tmp_path):
    for cls in ("sil", "speech"):
        assert jax_main(["gmm-global-init-from-feats", "--num-gauss=4",
                         "--num-iters=6", f"ark:{gmms / cls}.ark",
                         str(tmp_path / f"{cls}.npz")]) == 0
    return [str(tmp_path / "sil.npz"), str(tmp_path / "speech.npz")]


def test_apply_gmm_vad_matches_jax(data, gmms, tmp_path, capsys):
    models = _train_gmms(gmms, tmp_path)
    for flags in ([], ["--llr-threshold=1.5", "--lookback-ms=0"]):
        both(capsys, "aslp-apply-gmm-vad",
             flags + models + [f"ark:{data / 'feats.ark'}",
                               f"ark:{tmp_path / 'j.ark'}"],
             [CPU] + flags + models + [f"ark:{data / 'feats.ark'}",
                                       f"ark:{tmp_path / 't.ark'}"])
        assert_int_tables_equal(tmp_path / "j.ark", tmp_path / "t.ark")


def test_eval_gmm_vad_matches_jax(data, gmms, tmp_path, capsys):
    models = _train_gmms(gmms, tmp_path)
    args = models + [f"ark:{data / 'feats.ark'}", f"ark:{data / 'ref.ark'}"]
    out = both(capsys, "aslp-eval-gmm-vad", args, [CPU] + args)
    assert out.startswith("frames ") and "AUC" in out


# -- script tools -------------------------------------------------------------

def test_gen_textgrid_matches_jax(tmp_path, capsys):
    (tmp_path / "segment.info").write_text("[3, 40]\n[45, 90]\n[130, 150]\n")
    os.makedirs(tmp_path / "j")
    both(capsys, "aslp-gen-textgrid",
         [str(tmp_path / "segment.info"), str(tmp_path / "j" / "u0.TextGrid")],
         [str(tmp_path / "segment.info"), str(tmp_path / "u0.TextGrid")])
    assert (tmp_path / "u0.TextGrid").read_bytes() == \
        (tmp_path / "j" / "u0.TextGrid").read_bytes()
    assert 'name = "u0"' in (tmp_path / "u0.TextGrid").read_text()


def test_kws_gen_text_fst_matches_jax(tmp_path, capsys):
    (tmp_path / "kw.txt").write_text("niho ee ii oo\nhey h ey\nx\n")
    both(capsys, "aslp-kws-gen-text-fst",
         [str(tmp_path / "kw.txt"), str(tmp_path / "j.fst")],
         [str(tmp_path / "kw.txt"), str(tmp_path / "t.fst")])
    assert (tmp_path / "j.fst").read_bytes() == \
        (tmp_path / "t.fst").read_bytes()


def test_kws_generate_simulation_ali_matches_jax(tmp_path, capsys,
                                                 monkeypatch):
    (tmp_path / "wav.scp").write_text(
        "simulation_0_u1 a.wav\nsimulation_3_u2 b.wav\nu1 c.wav\n\n"
        "simulation_1_u9 d.wav\n")
    clean = "u1 1 1 2 3\nu2 4\n\n"
    outs = []
    for fn in (jax_main, main):
        monkeypatch.setattr(sys, "stdin", io.StringIO(clean))
        assert fn(["aslp-kws-generate-simulation-ali",
                   str(tmp_path / "wav.scp")]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == \
        "simulation_0_u1 1 1 2 3\nsimulation_3_u2 4\n"


def _progress_log(path, reporter_cls, name, steps=8):
    """A training log of ``reporter_cls``'s ProgressLoss lines."""
    import logging

    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("nnet-loss")
    handler = Capture()
    logger.addHandler(handler)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        rep = reporter_cls(name, progress_step=100)
        for k in range(steps):
            rep.update({"frames": torch.tensor(60.0),
                        "loss_sum": torch.tensor(60.0 * (3.0 - k * 0.3))}
                       if reporter_cls is LossReporter else
                       {"frames": 60.0, "loss_sum": 60.0 * (3.0 - k * 0.3)})
        rep.frames
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    lines = [r for r in records if "ProgressLoss" in r]
    path.write_text("".join(f"INFO (nnet-loss) {r}\n" for r in lines)
                    + "LOG other line 1.5\n")
    return lines


@pytest.mark.parametrize("name", ["aslp-log-analyse", "aslp-log-analyse-ctc"])
def test_log_analyse_reads_the_ports_lines_like_jax(name, tmp_path, capsys):
    port = _progress_log(tmp_path / "port.log", LossReporter, "xent")
    jax = _progress_log(tmp_path / "jax.log", JReporter, "xent")
    assert port == jax and len(port) >= 3
    for flags in ([], ["--sum=2", "--stride=1"]):
        out = both(capsys, name, flags + [str(tmp_path / "port.log")],
                   flags + [str(tmp_path / "port.log")])
    vals = [float(v) for v in out.split()]
    assert len(vals) == len(port) and vals[-1] < vals[0]


def test_mpi_log_analyse_matches_jax(tmp_path, capsys):
    d = tmp_path / "log"
    d.mkdir()
    for w in range(2):
        _progress_log(d / f"iter1.tr.log.{w}", LossReporter, "ctc", 4 + w)
    out = both(capsys, "aslp-mpi-log-analyse", [str(d)], [str(d)])
    assert out.split().count("0") >= 2
    both(capsys, "aslp-mpi-log-analyse", [str(d), "--pattern=none*"],
         [str(d), "--pattern=none*"], rc=1)
