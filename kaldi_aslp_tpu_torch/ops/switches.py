"""The JAX package's LSTM training switches, read as it reads them.

Three environment variables pick the training core of a bf16 LSTMP in
kaldi_aslp_tpu; the port honours the same three, with the same meaning:

  - ``KALDI_ASLP_LSTM_NO_XFUSE``: a bf16 BLSTMP trains through the
    xg-fed core (``bilstmp_train_core``) instead of the x-fused one
    (models/recurrent.py:462-463);
  - ``KALDI_ASLP_LSTM_MXU_FP32``: float32 recurrent products with bf16
    storage, for a bf16 BLSTMP through the xg-fed core
    (recurrent.py:455) and for a bf16 LSTMP (recurrent.py:180-181);
  - ``KALDI_ASLP_LSTM_SPLIT_BWD``: the x-fused core's backward runs one
    direction at a time (ops/lstm_pallas.py:1612).

Any non-empty value sets a switch, as ``os.environ.get`` does there."""

from __future__ import annotations

import os
from typing import NamedTuple


class LstmSwitches(NamedTuple):
    no_xfuse: bool
    mxu_fp32: bool
    split_bwd: bool


def lstm_switches() -> LstmSwitches:
    """The three switches as they stand now (read at every call, as the
    JAX package reads them at trace time)."""
    return LstmSwitches(
        no_xfuse=bool(os.environ.get("KALDI_ASLP_LSTM_NO_XFUSE")),
        mxu_fp32=bool(os.environ.get("KALDI_ASLP_LSTM_MXU_FP32")),
        split_bwd=bool(os.environ.get("KALDI_ASLP_LSTM_SPLIT_BWD")))
