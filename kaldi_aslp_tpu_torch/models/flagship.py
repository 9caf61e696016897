"""Flagship model builder: the BLSTM-CTC acoustic model.

Port of kaldi_aslp_tpu/models/flagship.py:build_blstm_ctc (reference
recipe: aslp_scripts/ctc/ + run_lstm.sh proto shapes).  The network is
built with zero parameters; draw them with
``net.reset_parameters(generator)`` or load them with ``Nnet.load``."""

from __future__ import annotations

from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.models.recurrent import BLstmProjectedStreams
from kaldi_aslp_tpu_torch.models.simple import AffineTransform


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
