"""The nnet CLI tools and the MIMO frame trainer
(kaldi_aslp_tpu_torch/cli/nnet_tools.py, train_tools.py) against the JAX
package's tools on the same files: each of the 17 registry names this
slice adds, its tables equal to JAX's (bytes where the tool is host
numpy), or within 1e-5 where a net runs; the MIMO trainer's parameters
after an epoch within 1e-4 of JAX's, its arity checks and its
``--cross-validate`` (no update, no model written)."""

import io
import json
import os
import pickle
import zipfile

import numpy as np
import pytest
import torch

import jax

import kaldi_aslp_tpu.models as J
from kaldi_aslp_tpu.cli.__main__ import TOOLS as JAX_TOOLS, main as jax_main
from kaldi_aslp_tpu.hmm import HmmTopology as JaxTopology
from kaldi_aslp_tpu.hmm import TransitionModel as JaxTransitionModel
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS, main
from kaldi_aslp_tpu_torch.hmm import HmmTopology, TransitionModel
from kaldi_aslp_tpu_torch.io import (
    int_vector_writer,
    matrix_writer,
    sequential_int_vector_reader,
    sequential_matrix_reader,
    sequential_vector_reader,
)
from kaldi_aslp_tpu_torch.models import Nnet

torch.set_num_threads(1)

NEW_TOOLS = [
    "aslp-nnet-init", "aslp-nnet-info", "aslp-nnet-copy", "aslp-nnet-dot",
    "aslp-nnet-forward-mimo", "aslp-nnet-insert",
    "aslp-nnet-convert-to-standard", "ali-to-pdf", "aslp-ali-to-pdf",
    "aslp-ali-minus-one", "analyze-counts", "aslp-ali-to-matrix",
    "aslp-matrix-to-txt", "aslp-txt-to-matrix",
    "aslp-copy-vector-from-matrix", "aslp-extract-transition-to-pdf",
    "aslp-nnet-train-frame-mimo"]
CPU = "--device=cpu"
NET_TOL, TRAIN_TOL = 1e-5, 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _arrays(path):
    with zipfile.ZipFile(path) as z:
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return {k: npz[k] for k in npz.files}


def _topology(path):
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("topology.json"))


def _same_model(a, b, tol=0.0):
    assert _topology(a) == _topology(b)
    x, y = _arrays(a), _arrays(b)
    assert sorted(x) == sorted(y)
    for k in x:
        if tol:
            assert _rel(x[k], y[k]) <= tol, k
        else:
            assert np.array_equal(x[k], y[k]), k


def _run_both(capsys, argv):
    """Run the JAX tool, then the port's on ``argv`` (the port's with
    --device=cpu where the tool takes it); returns both stdouts."""
    assert jax_main(list(argv)) == 0
    jout = capsys.readouterr().out
    port_argv = [argv[0]] + ([CPU] if _takes_device(argv[0]) else []) \
        + list(argv[1:])
    assert main(port_argv) == 0
    return jout, capsys.readouterr().out


def _takes_device(tool):
    return tool.startswith("aslp-nnet-")


PROTO = """<NnetProto>
<Splice> <InputDim> 4 <OutputDim> 12 <BuildVector> -1:1
<AffineTransform> <InputDim> 12 <OutputDim> 10 <ParamStddev> 0.2
<BatchNormalization> <InputDim> 10 <OutputDim> 10
<Tanh> <InputDim> 10 <OutputDim> 10
<AffineTransform> <InputDim> 10 <OutputDim> 5
<Softmax> <InputDim> 5 <OutputDim> 5
</NnetProto>
"""


@pytest.fixture
def dnn(tmp_path):
    """A JAX-initialized chain (from PROTO) with a BN state."""
    jnet = J.Nnet.from_proto(PROTO)
    params = jnet.init(jax.random.PRNGKey(4))
    states = jnet.init_state(2)
    states["2"]["sum"] = states["2"]["sum"] + 1.5
    states["2"]["count"] = states["2"]["count"] + 3.0
    path = str(tmp_path / "dnn.zip")
    jnet.save(path, params, states)
    return path


def test_registry_names_map_like_jax():
    assert len(TOOLS) == 98  # 70 until the application layer's 28
    for name in NEW_TOOLS:
        assert name in TOOLS and name in JAX_TOOLS, name
        assert TOOLS[name].__name__ == JAX_TOOLS[name].__name__, name
    assert set(TOOLS) <= set(JAX_TOOLS)


def test_nnet_init_matches_jax_topology(tmp_path):
    proto = tmp_path / "net.proto"
    proto.write_text(PROTO)
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    assert jax_main(["aslp-nnet-init", str(proto), jout]) == 0
    assert main(["aslp-nnet-init", CPU, str(proto), out]) == 0
    assert _topology(out) == _topology(jout)
    a, b = _arrays(out), _arrays(jout)
    assert {k: v.shape for k, v in a.items()} == {
        k: v.shape for k, v in b.items()}
    # BN starts at gamma 1, beta 0 in both; the seed fixes the draws
    assert np.array_equal(a["['params']['2']['gamma']"], np.ones(10))
    again = str(tmp_path / "p2.zip")
    assert main(["aslp-nnet-init", CPU, str(proto), again]) == 0
    _same_model(out, again)
    other = str(tmp_path / "p3.zip")
    assert main(["aslp-nnet-init", CPU, "--seed=5", str(proto), other]) == 0
    assert not np.array_equal(_arrays(other)["['params']['1']['w']"],
                              a["['params']['1']['w']"])


def test_nnet_info_and_dot_print_jax_text(tmp_path, dnn, capsys):
    jout, out = _run_both(capsys, ["aslp-nnet-info", dnn])
    assert out == jout and "number-of-parameters" in out
    jout, out = _run_both(capsys, ["aslp-nnet-dot", dnn])
    assert out == jout and out.startswith("digraph nnet {")
    jdot, dot = str(tmp_path / "j.dot"), str(tmp_path / "p.dot")
    assert jax_main(["aslp-nnet-dot", dnn, jdot]) == 0
    assert main(["aslp-nnet-dot", CPU, dnn, dot]) == 0
    assert open(dot).read() == open(jdot).read()


def test_nnet_copy_keeps_params_and_state(tmp_path, dnn):
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    assert jax_main(["aslp-nnet-copy", dnn, jout]) == 0
    assert main(["aslp-nnet-copy", CPU, dnn, out]) == 0
    _same_model(out, jout)
    _same_model(out, dnn)
    assert "['states']['2']['count']" in _arrays(out)


def _mimo_net(path):
    """2 inputs (5 and 4 wide) spliced into a shared hidden layer, then 2
    heads (3 classes, 2 regression outputs): tests/test_cli_mimo.py's."""
    jnet = J.Nnet(num_inputs=2)
    h = jnet.add(J.AffineTransform(9, 8), inputs=[("in:0", 0), ("in:1", 5)])
    t = jnet.add(J.Tanh(8, 8), inputs=[(h, 0)])
    jnet.add(J.AffineTransform(8, 3), inputs=[(t, 0)])
    jnet.add(J.AffineTransform(8, 2), inputs=[(t, 0)])
    params = jnet.init(jax.random.PRNGKey(3))
    jnet.save(path, params)
    return jnet, params


def _mimo_corpus(tmp_path, n_utts=6, T=20, seed=0):
    rs = np.random.RandomState(seed)
    names = [str(tmp_path / f"{n}.ark") for n in ("f1", "f2", "t1", "t2")]
    with matrix_writer(f"ark:{names[0]}") as w1, \
            matrix_writer(f"ark:{names[1]}") as w2, \
            int_vector_writer(f"ark:{names[2]}") as wt1, \
            matrix_writer(f"ark:{names[3]}") as wt2:
        for u in range(n_utts):
            key = f"utt{u}"
            w1[key] = rs.randn(T, 5).astype(np.float32)
            w2[key] = rs.randn(T, 4).astype(np.float32)
            wt1[key] = rs.randint(0, 3, T).astype(np.int32)
            wt2[key] = rs.randn(T, 2).astype(np.float32)
    return [f"ark:{n}" for n in names]


@pytest.mark.parametrize("flags", [[], ["--no-softmax=true",
                                        "--apply-log=false"]],
                         ids=["log-softmax", "raw"])
def test_forward_mimo_matches_jax(tmp_path, flags):
    model = str(tmp_path / "mimo.zip")
    _mimo_net(model)
    f1, f2, _, _ = _mimo_corpus(tmp_path)
    jout, out = str(tmp_path / "j.ark"), str(tmp_path / "p.ark")
    assert jax_main(["aslp-nnet-forward-mimo", *flags, model, f1, f2,
                     f"ark:{jout}"]) == 0
    assert main(["aslp-nnet-forward-mimo", CPU, *flags, model, f1, f2,
                 f"ark:{out}"]) == 0
    want = dict(sequential_matrix_reader(f"ark:{jout}"))
    got = dict(sequential_matrix_reader(f"ark:{out}"))
    assert sorted(got) == sorted(want) and len(got) == 6
    for utt in want:
        assert got[utt].shape == (20, 2)   # the last head
        assert _rel(got[utt], want[utt]) <= NET_TOL
    # one feature table for a two-input net: refused
    assert main(["aslp-nnet-forward-mimo", CPU, model, f1,
                 f"ark:{out}"]) == 1


@pytest.mark.parametrize("randomize", [False, True],
                         ids=["keep-next", "redraw-next"])
def test_nnet_insert_matches_jax(tmp_path, dnn, randomize):
    hidden = tmp_path / "hidden.proto"
    hidden.write_text("<AffineTransform> <InputDim> 10 <OutputDim> 10\n"
                      "<Sigmoid> <InputDim> 10 <OutputDim> 10\n")
    ins = str(tmp_path / "ins.zip")
    jnet = J.Nnet.from_proto(hidden.read_text())
    jnet.save(ins, jnet.init(jax.random.PRNGKey(9)))
    flag = f"--randomize-next-component={'true' if randomize else 'false'}"
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    assert jax_main(["aslp-nnet-insert", flag, dnn, ins, jout]) == 0
    assert main(["aslp-nnet-insert", CPU, flag, dnn, ins, out]) == 0
    assert _topology(out) == _topology(jout)
    a, b = _arrays(out), _arrays(jout)
    assert sorted(a) == sorted(b)
    # inserted before the last updatable component (the output affine,
    # node 4), which becomes node 6 and is re-drawn when asked
    redrawn = {k for k in a if k.startswith("['params']['6']")}
    assert len(redrawn) == 2
    for k in a:
        if randomize and k in redrawn:
            assert a[k].shape == b[k].shape
            assert 0 < np.abs(a[k]).max() < 0.2
        else:
            assert np.array_equal(a[k], b[k]), k
    # a net with nothing updatable
    plain = str(tmp_path / "plain.zip")
    jn = J.Nnet()
    jn.add(J.Tanh(3, 3))
    jn.save(plain, jn.init(jax.random.PRNGKey(0)))
    assert main(["aslp-nnet-insert", CPU, plain, ins, out]) == 1


def test_convert_to_standard_matches_jax(tmp_path, dnn):
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    assert jax_main(["aslp-nnet-convert-to-standard", dnn, jout]) == 0
    assert main(["aslp-nnet-convert-to-standard", CPU, dnn, out]) == 0
    _same_model(out, jout)
    mimo = str(tmp_path / "mimo.zip")
    _mimo_net(mimo)
    assert jax_main(["aslp-nnet-convert-to-standard", mimo, jout]) == 1
    assert main(["aslp-nnet-convert-to-standard", CPU, mimo, out]) == 1


def _alignments(tmp_path, rs, high=9, lo=0):
    path = str(tmp_path / "ali.ark")
    with int_vector_writer(f"ark:{path}") as w:
        for u in range(5):
            w[f"u{u}"] = rs.randint(lo, high, rs.randint(3, 12)).astype(
                np.int32)
    return f"ark:{path}"


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("tool", ["ali-to-pdf", "aslp-ali-to-pdf"])
def test_ali_to_pdf_matches_jax(tmp_path, tool):
    rs = np.random.RandomState(1)
    lut = tmp_path / "tid2pdf.txt"
    np.savetxt(lut, rs.randint(0, 4, 9).reshape(-1, 1), fmt="%d")
    ali = _alignments(tmp_path, rs)
    jout, out = str(tmp_path / "j.ark"), str(tmp_path / "p.ark")
    assert jax_main([tool, str(lut), ali, f"ark:{jout}"]) == 0
    assert main([tool, str(lut), ali, f"ark:{out}"]) == 0
    _same_file(out, jout)


@pytest.mark.parametrize("tool,flags", [
    ("aslp-ali-minus-one", []),
    ("aslp-ali-to-matrix", ["--dict-size=10"]),
    ("analyze-counts", ["--num-classes=4"]),
    ("analyze-counts", [])],
    ids=["minus-one", "to-matrix", "counts-4", "counts"])
def test_alignment_tools_match_jax(tmp_path, tool, flags):
    ali = _alignments(tmp_path, np.random.RandomState(2), lo=1)
    jout, out = str(tmp_path / "j.out"), str(tmp_path / "p.out")
    spec = (lambda p: p) if tool == "analyze-counts" else (
        lambda p: f"ark:{p}")
    assert jax_main([tool, *flags, ali, spec(jout)]) == 0
    assert main([tool, *flags, ali, spec(out)]) == 0
    _same_file(out, jout)


def test_ali_to_matrix_refuses_labels_past_the_dict(tmp_path):
    ali = _alignments(tmp_path, np.random.RandomState(2))
    out = f"ark:{tmp_path / 'm.ark'}"
    assert main(["aslp-ali-to-matrix", "--dict-size=3", ali, out]) == 1
    assert main(["aslp-ali-to-matrix", ali, out]) == 1


def test_matrix_text_tools_match_jax(tmp_path):
    rs = np.random.RandomState(3)
    mats = str(tmp_path / "m.ark")
    with matrix_writer(f"ark:{mats}") as w:
        for u in range(3):
            w[f"k{u}"] = rs.randn(rs.randint(2, 6), 4).astype(np.float32)
    jtxt, txt = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    assert jax_main(["aslp-matrix-to-txt", f"ark:{mats}", jtxt]) == 0
    assert main(["aslp-matrix-to-txt", f"ark:{mats}", txt]) == 0
    _same_file(txt, jtxt)
    # text back to a table: blank-line separated blocks
    with open(txt) as f:
        lines = f.read().splitlines()
    blocks, cur = [], []
    for ln in lines:
        if not ln[0].isdigit() and not ln[0] == "-" and cur:
            blocks.append(cur)
            cur = []
        cur.append(ln)
    blocks.append(cur)
    with open(tmp_path / "blocks.txt", "w") as f:
        f.write("\n\n".join("\n".join(b) for b in blocks) + "\n")
    jm, m = str(tmp_path / "j.ark"), str(tmp_path / "p.ark")
    assert jax_main(["aslp-txt-to-matrix", str(tmp_path / "blocks.txt"),
                     f"ark:{jm}"]) == 0
    assert main(["aslp-txt-to-matrix", str(tmp_path / "blocks.txt"),
                 f"ark:{m}"]) == 0
    _same_file(m, jm)
    assert sorted(dict(sequential_matrix_reader(f"ark:{m}"))) == [
        "k0", "k1", "k2"]
    jv, v = str(tmp_path / "j.vec"), str(tmp_path / "p.vec")
    assert jax_main(["aslp-copy-vector-from-matrix", "--column=2",
                     f"ark:{mats}", f"ark:{jv}"]) == 0
    assert main(["aslp-copy-vector-from-matrix", "--column=2",
                 f"ark:{mats}", f"ark:{v}"]) == 0
    _same_file(v, jv)
    got = dict(sequential_vector_reader(f"ark:{v}"))
    want = dict(sequential_matrix_reader(f"ark:{mats}"))
    for k in want:
        assert np.array_equal(got[k], want[k][:, 2])


def test_extract_transition_to_pdf_matches_jax(tmp_path):
    phones = [1, 2, 3, 4]
    mapping = {}
    for ph in phones:
        for pc in range(5):
            mapping[(ph, pc)] = (ph * 3 + pc) % 7

    def pdf(phone, pdf_class):
        return mapping[(phone, pdf_class)]

    tm = TransitionModel(HmmTopology.default(phones, sil_phones=[4]), pdf)
    jtm = JaxTransitionModel(JaxTopology.default(phones, sil_phones=[4]),
                             pdf)
    for name, model in (("p.pkl", tm), ("j.pkl", jtm)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(model, f)
    jout, out = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    assert jax_main(["aslp-extract-transition-to-pdf",
                     str(tmp_path / "j.pkl"), jout]) == 0
    assert main(["aslp-extract-transition-to-pdf", str(tmp_path / "p.pkl"),
                 out]) == 0
    _same_file(out, jout)
    assert len(open(out).read().split()) == tm.num_transition_ids + 1


def test_train_frame_mimo_matches_jax(tmp_path, capsys):
    model = str(tmp_path / "mimo.zip")
    _mimo_net(model)
    f1, f2, t1, t2 = _mimo_corpus(tmp_path)
    args = ["--objective-function=xent:mse", "--minibatch-size=16",
            "--learn-rate=0.05", "--momentum=0.5", "--randomizer-size=64",
            f1, f2, t1, t2, model]
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    assert jax_main(["aslp-nnet-train-frame-mimo", *args, jout]) == 0
    jrep = capsys.readouterr().out
    assert main(["aslp-nnet-train-frame-mimo", CPU, *args, out]) == 0
    rep = capsys.readouterr().out
    assert "[output 0]" in rep and "[output 1]" in rep
    assert "FRAME_ACCURACY" in rep
    _same_model(out, jout, tol=TRAIN_TOL)
    assert not np.array_equal(_arrays(out)["['params']['0']['w']"],
                              _arrays(model)["['params']['0']['w']"])
    # the reports: frames equal, losses within the tolerance
    for line, jline in zip(rep.splitlines(), jrep.splitlines()):
        if "AvgLoss" in line:
            a, b = float(line.split()[3]), float(jline.split()[3])
            assert abs(a - b) <= TRAIN_TOL * abs(b)
            assert line.split("[frames")[1] == jline.split("[frames")[1]


def test_train_frame_mimo_arity_and_cross_validate(tmp_path, capsys):
    model = str(tmp_path / "mimo.zip")
    _mimo_net(model)
    f1, f2, t1, t2 = _mimo_corpus(tmp_path, n_utts=3)
    out = str(tmp_path / "x.zip")
    tool = "aslp-nnet-train-frame-mimo"
    # one target table short, and an objective short
    assert main([tool, CPU, "--objective-function=xent:mse", f1, f2, t1,
                 model, out]) == 1
    assert main([tool, CPU, "--objective-function=xent", f1, f2, t1, t2,
                 model, out]) == 1
    assert main([tool, CPU, "--objective-function=xent:ctc", f1, f2, t1, t2,
                 model, out]) == 1
    assert not os.path.exists(out)
    capsys.readouterr()
    cv = ["--cross-validate=true", "--objective-function=xent:mse",
          "--minibatch-size=16", f1, f2, t1, t2, model]
    assert jax_main([tool, *cv]) == 0
    jrep = capsys.readouterr().out
    before = _arrays(model)
    assert main([tool, CPU, *cv]) == 0
    rep = capsys.readouterr().out
    assert rep.count("[output") == 2 and "FRAME_ACCURACY" in rep
    for line, jline in zip(rep.splitlines(), jrep.splitlines()):
        if "AvgLoss" in line:
            a, b = float(line.split()[3]), float(jline.split()[3])
            assert abs(a - b) <= NET_TOL * abs(b)
    after = _arrays(model)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_train_frame_mimo_takes_a_recurrent_net_as_one_frame_streams(
        tmp_path, capsys):
    """A net with a time axis (here a GRU and a cFSMN) sees each shuffled
    frame as a stream of one frame, as the port's frame trainer does; the
    JAX tool hands it the [N, D] minibatch, which the GRU cannot unpack
    (ROADMAP queue 3)."""
    jnet = J.Nnet(num_inputs=2)
    h = jnet.add(J.GruStreams(9, 6), inputs=[("in:0", 0), ("in:1", 5)])
    f = jnet.add(J.CompactFsmn(6, 6, l_order=1, r_order=1),
                 inputs=[(h, 0)])
    jnet.add(J.AffineTransform(6, 3), inputs=[(f, 0)])
    jnet.add(J.AffineTransform(6, 2), inputs=[(h, 0)])
    model = str(tmp_path / "rnn.zip")
    jnet.save(model, jnet.init(jax.random.PRNGKey(0)))
    f1, f2, t1, t2 = _mimo_corpus(tmp_path, n_utts=2, T=10)
    out = str(tmp_path / "out.zip")
    with pytest.raises(ValueError):
        jax_main(["aslp-nnet-train-frame-mimo", "--minibatch-size=8",
                  "--objective-function=xent:mse", f1, f2, t1, t2, model,
                  str(tmp_path / "jax.zip")])
    assert main(["aslp-nnet-train-frame-mimo", CPU, "--minibatch-size=8",
                 "--objective-function=xent:mse", f1, f2, t1, t2, model,
                 out]) == 0
    assert capsys.readouterr().out.count("AvgLoss") == 2
    net, _ = Nnet.load(out, "cpu")
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_device_tools_never_drop_to_cpu(tmp_path, dnn):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    for argv in (["aslp-nnet-info", dnn], ["aslp-nnet-copy", dnn, "x.zip"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
