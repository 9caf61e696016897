"""CLI dispatcher: ``python -m kaldi_aslp_tpu_torch.cli <tool> [args]``.

Port of kaldi_aslp_tpu/cli/__main__.py.  The tool names mirror the
reference binaries; the port has the online server and its client, the
CTC trainer, the BPTT trainer, the network forward, the lattice
generator and lattice tools, and compute-wer so far.  As in the JAX
package, the BLSTM, LC-BLSTM, skip and per-utterance BPTT binaries are
one trainer and the forward's -skip / -blstm-lc variants one forward:
the architecture lives in the model file, and a model with a component
the port lacks fails at load with the registry's error."""

from __future__ import annotations

import sys

from kaldi_aslp_tpu_torch.cli import (
    lat_tools,
    nnet_tools,
    online_tools,
    train_tools,
)

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
    # aslp-nnetbin forward: -skip / -blstm-lc are the same main
    "aslp-nnet-forward": nnet_tools.nnet_forward_cli,
    "aslp-nnet-forward-skip": nnet_tools.nnet_forward_cli,
    "aslp-nnet-forward-blstm-lc": nnet_tools.nnet_forward_cli,
    # latbin, bin
    "lattice-best-path": lat_tools.lattice_best_path_cli,
    "lattice-scale": lat_tools.lattice_scale_cli,
    "lattice-copy": lat_tools.lattice_copy_cli,
    "lattice-determinize": lat_tools.lattice_determinize_cli,
    "lattice-lmrescore": lat_tools.lattice_lmrescore_cli,
    "latgen-faster-mapped": lat_tools.latgen_faster_mapped_cli,
    "aslp-latgen-faster-rtf": lat_tools.latgen_faster_rtf_cli,
    "compute-wer": nnet_tools.compute_wer,
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
