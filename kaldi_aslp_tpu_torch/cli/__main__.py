"""CLI dispatcher: ``python -m kaldi_aslp_tpu_torch.cli <tool> [args]``.

Port of kaldi_aslp_tpu/cli/__main__.py.  The tool names mirror the
reference binaries; the port has the online server and its client, the
CTC trainer and the BPTT trainer so far.  As in the JAX package, the
BLSTM, LC-BLSTM, skip and per-utterance BPTT binaries are one trainer:
the architecture lives in the model file, and a model with a component
the port lacks fails at load with the registry's error."""

from __future__ import annotations

import sys

from kaldi_aslp_tpu_torch.cli import online_tools, train_tools

TOOLS = {
    # aslp-onlinebin server + client
    "aslp-online-nnet-vad-server": online_tools.online_nnet_vad_server,
    "aslp-audio-provider-client": online_tools.audio_provider_client,
    # aslp-nnetbin trainers
    "aslp-nnet-train-ctc-streams": train_tools.nnet_train_ctc_streams,
    "aslp-nnet-train-lstm-streams": train_tools.nnet_train_lstm_streams,
    "aslp-nnet-train-lstm-streams-skip": train_tools.nnet_train_lstm_streams,
    "aslp-nnet-train-blstm-streams": train_tools.nnet_train_lstm_streams,
    "aslp-nnet-train-blstm-streams-lc": train_tools.nnet_train_lstm_streams,
    "aslp-nnet-train-blstm-parallel": train_tools.nnet_train_lstm_streams,
    "aslp-nnet-train-perutt": train_tools.nnet_train_lstm_streams,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m kaldi_aslp_tpu_torch.cli <tool> [args]\n"
              "tools:\n  " + "\n  ".join(sorted(TOOLS)), file=sys.stderr)
        return 1
    tool = argv[0]
    if tool not in TOOLS:
        print(f"unknown tool {tool!r}; run with --help for the list",
              file=sys.stderr)
        return 1
    return TOOLS[tool](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
