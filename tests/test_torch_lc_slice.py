"""The latency-controlled BLSTMP hybrid end to end through the CLI, at a
small size on the CPU, against the JAX package's tools on the same files:
``aslp-nnet-init`` from an LC proto (the same topology and shapes), a few
truncated-BPTT steps of ``aslp-nnet-train-blstm-streams-lc`` from the
same (JAX-initialized) model, and ``aslp-nnet-forward-blstm-lc`` with
each package's trained model.  The port runs its kernels' plain versions
(``LstmpTrainCore``'s plain path, ``lstmp_forward_reference``).

Tolerances, as max |port - JAX| / max |JAX|: 1e-4 for the trained
parameters and the log-likelihoods, 1e-4 relative for the losses (the
same float32 math over a few steps, summed in another order)."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.cli.__main__ import main as jax_main
from kaldi_aslp_tpu_torch.cli.__main__ import main
from kaldi_aslp_tpu_torch.io import (
    int_vector_writer,
    matrix_writer,
    sequential_matrix_reader,
)
from kaldi_aslp_tpu_torch.models import BLstmProjectedStreamsLC, Nnet

torch.set_num_threads(1)

D, CELL, PROJ, PDFS, CHUNK = 6, 8, 4, 5, 4
TOL = 1e-4
PROTO = f"""<NnetProto>
<BLstmProjectedStreamsLC> <InputDim> {D} <OutputDim> {2 * PROJ} <CellDim> {CELL} <ChunkSize> {CHUNK}
<BLstmProjectedStreamsLC> <InputDim> {2 * PROJ} <OutputDim> {2 * PROJ} <CellDim> {CELL} <ChunkSize> {CHUNK}
<AffineTransform> <InputDim> {2 * PROJ} <OutputDim> {PDFS} <ParamStddev> 0.3 <BiasMean> 0.0 <BiasRange> 0.0
</NnetProto>
"""
TRAIN = ["--num-streams=3", "--batch-size=5", "--targets-delay=1",
         "--learn-rate=0.1", "--momentum=0.5"]


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


def _corpus(tmp_path):
    """Utterances of 3-14 frames (below, at and past the chunk) whose
    targets are a function of the features."""
    rs = np.random.RandomState(17)
    proj = rs.randn(D, PDFS)
    feats, ali = tmp_path / "feats.ark", tmp_path / "ali.ark"
    with matrix_writer(f"ark:{feats}") as fw, \
            int_vector_writer(f"ark:{ali}") as tw:
        for i, n in enumerate([9, 4, 14, 3, 8, 12, 5, 11]):
            x = rs.randn(n, D).astype(np.float32)
            fw[f"utt{i}"] = x
            tw[f"utt{i}"] = np.argmax(x @ proj, axis=1).astype(np.int32)
    return f"ark:{feats}", f"ark:{ali}"


def _avg_loss(text):
    line = next(ln for ln in text.splitlines() if "AvgLoss" in ln)
    return float(line.split()[1]), line.split("[frames")[1]


def test_lc_hybrid_init_train_forward_match_jax(tmp_path, capsys):
    proto = tmp_path / "lc.proto"
    proto.write_text(PROTO)
    jinit, pinit = str(tmp_path / "j_init.zip"), str(tmp_path / "p_init.zip")
    assert jax_main(["aslp-nnet-init", str(proto), jinit]) == 0
    assert main(["aslp-nnet-init", "--device=cpu", str(proto), pinit]) == 0
    assert _topology(pinit) == _topology(jinit)
    assert {k: v.shape for k, v in _arrays(pinit).items()} == {
        k: v.shape for k, v in _arrays(jinit).items()}
    net, _ = Nnet.load(pinit, "cpu")
    assert [type(c) for c in net.nodes][:2] == [BLstmProjectedStreamsLC] * 2
    assert net.nodes[0].chunk_size == CHUNK

    feats, ali = _corpus(tmp_path)
    capsys.readouterr()
    jout, out = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    tool = "aslp-nnet-train-blstm-streams-lc"
    assert jax_main([tool, *TRAIN, feats, ali, jinit, jout]) == 0
    jrep = capsys.readouterr().out
    assert main([tool, "--device=cpu", *TRAIN, feats, ali, jinit, out]) == 0
    rep = capsys.readouterr().out
    (loss, frames), (jloss, jframes) = _avg_loss(rep), _avg_loss(jrep)
    assert frames == jframes
    assert abs(loss - jloss) <= TOL * abs(jloss)
    assert _topology(out) == _topology(jout)
    got, want, init = _arrays(out), _arrays(jout), _arrays(jinit)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= TOL, k
    assert max(np.abs(got[k] - init[k]).max() for k in got) > 1e-3

    # the cross-validation pass: the same loss, no model written
    cv = str(tmp_path / "cv.zip")
    assert jax_main([tool, *TRAIN, "--cross-validate=true", feats, ali,
                     jout]) == 0
    capsys.readouterr()
    assert main([tool, "--device=cpu", *TRAIN, "--cross-validate=true",
                 feats, ali, out, cv]) == 0
    assert "FRAME_ACCURACY" in capsys.readouterr().out

    fwd = "aslp-nnet-forward-blstm-lc"
    jll, ll = str(tmp_path / "j_ll.ark"), str(tmp_path / "p_ll.ark")
    assert jax_main([fwd, jout, feats, f"ark:{jll}"]) == 0
    assert main([fwd, "--device=cpu", out, feats, f"ark:{ll}"]) == 0
    want_ll = dict(sequential_matrix_reader(f"ark:{jll}"))
    got_ll = dict(sequential_matrix_reader(f"ark:{ll}"))
    assert sorted(got_ll) == sorted(want_ll) and len(got_ll) == 8
    for utt in want_ll:
        assert got_ll[utt].shape == want_ll[utt].shape
        assert _rel(got_ll[utt], want_ll[utt]) <= TOL, utt
        assert np.allclose(np.exp(got_ll[utt]).sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lc_training_step_is_two_lstmp_cores_a_layer(tmp_path, bf16):
    """With the ``bf16`` attr each direction takes the bf16 route of
    ``LstmProjectedStreams._forward_train`` (bf16 storage): one step
    still trains, finite."""
    proto = PROTO.replace("<ChunkSize>", "<Bf16> <ChunkSize>") if bf16 \
        else PROTO
    net = Nnet.from_proto(proto)
    net.reset_parameters(torch.Generator().manual_seed(1))
    assert net.nodes[0].fwd.attrs.get("bf16", False) is bf16
    from kaldi_aslp_tpu_torch.train import (
        LstmStreamsTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    trainer = LstmStreamsTrainer(net, NnetTrainOptions(learn_rate=0.1))
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(3, 5, D).astype(np.float32))
    targets = torch.from_numpy(rs.randint(0, PDFS, (3, 5)))
    mask = torch.ones(3, 5)
    flags = torch.zeros(3)
    states, loss, _ = trainer.step(init_velocity(net), trainer.init_state(3),
                                   (feats, targets, mask, flags), 0.1)
    assert torch.isfinite(loss)
    assert sorted(states) == ["0", "1"] and sorted(states["0"]) == ["fwd"]
