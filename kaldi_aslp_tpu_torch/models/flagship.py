"""Model builders: the BLSTM-CTC flagship, the LSTM hybrid and the DNN
hybrid.

Port of kaldi_aslp_tpu/models/flagship.py:build_blstm_ctc,
build_lstm_hybrid and build_dnn_hybrid (reference recipes:
aslp_scripts/ctc/, run_lstm.sh and run_dnn.sh proto shapes).  The networks are built with zero parameters; draw them
with ``net.reset_parameters(generator)`` or load them with
``Nnet.load``."""

from __future__ import annotations

from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.models.recurrent import (
    BLstmProjectedStreams,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu_torch.models.simple import AffineTransform, Sigmoid


def build_blstm_ctc(
    input_dim: int = 40,
    num_layers: int = 3,
    proj_dim: int = 320,
    cell_dim: int = 512,
    num_targets: int = 72,  # mono phones*2+1 style CTC inventory
) -> Nnet:
    """BLSTM-CTC flagship (reference: aslp-nnet-train-ctc-streams models)."""
    net = Nnet()
    dim = input_dim
    for _ in range(num_layers):
        net.add(BLstmProjectedStreams(dim, 2 * proj_dim, cell_dim=cell_dim))
        dim = 2 * proj_dim
    net.add(AffineTransform(dim, num_targets, param_stddev=0.04,
                            bias_mean=0.0, bias_range=0.0))
    return net


def build_lstm_hybrid(
    input_dim: int = 40,
    num_layers: int = 2,
    proj_dim: int = 512,
    cell_dim: int = 800,
    num_pdfs: int = 3019,
) -> Nnet:
    """LSTM hybrid CE model (reference: run_lstm.sh proto at :64-72)."""
    net = Nnet()
    dim = input_dim
    for _ in range(num_layers):
        net.add(LstmProjectedStreams(dim, proj_dim, cell_dim=cell_dim))
        dim = proj_dim
    net.add(AffineTransform(dim, num_pdfs, param_stddev=0.04,
                            bias_mean=0.0, bias_range=0.0))
    return net


def build_dnn_hybrid(
    input_dim: int = 440,  # 40 fbank x 11 splice
    hidden_dim: int = 1024,
    num_layers: int = 4,
    num_pdfs: int = 3019,
) -> Nnet:
    """Feed-forward DNN hybrid (reference: run_dnn.sh)."""
    net = Nnet()
    dim = input_dim
    for _ in range(num_layers):
        net.add(AffineTransform(dim, hidden_dim, param_stddev=0.1))
        net.add(Sigmoid(hidden_dim, hidden_dim))
        dim = hidden_dim
    net.add(AffineTransform(dim, num_pdfs, param_stddev=0.04,
                            bias_mean=0.0, bias_range=0.0))
    return net
