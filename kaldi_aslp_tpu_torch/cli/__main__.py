"""CLI dispatcher: ``python -m kaldi_aslp_tpu_torch.cli <tool> [args]``.

Port of kaldi_aslp_tpu/cli/__main__.py.  The tool names mirror the
reference binaries; the port has every name of the JAX registry but the
five MPI workers of distributed training (``aslp-nnet-train-frame-worker``,
``-lstm-stream-worker``, ``-lc-blstm-streams-worker``, ``-simple-mpi``,
``aslp-nnet-train-server``): 98 of 103.  As in the JAX package, the
BLSTM, LC-BLSTM, skip and per-utterance BPTT binaries are one trainer,
the warp-ctc and per-utterance CTC binaries the CTC trainer, the
forward's -skip / -blstm-lc variants one forward, the NN-VAD apply
binaries one tool and the VAD eval binaries two: the architecture lives
in the model file, and a model with a component the port lacks fails at
load with the registry's error."""

from __future__ import annotations

import sys

from kaldi_aslp_tpu_torch.cli import (
    feat_tools,
    fst_tools,
    lat_tools,
    nnet_tools,
    online_tools,
    script_tools,
    train_tools,
    tree_tools,
    vad_tools,
)

TOOLS = {
    # featbin
    "compute-mfcc-feats": feat_tools.compute_mfcc_feats,
    "compute-fbank-feats": feat_tools.compute_fbank_feats,
    "copy-feats": feat_tools.copy_feats,
    "compute-cmvn-stats": feat_tools.compute_cmvn_stats,
    "apply-cmvn": feat_tools.apply_cmvn_cli,
    "add-deltas": feat_tools.add_deltas_cli,
    "splice-feats": feat_tools.splice_feats,
    "feat-to-dim": feat_tools.feat_to_dim,
    # pitch, aslp-vadbin spectrum
    "compute-kaldi-pitch-feats": vad_tools.compute_pitch_cli,
    "aslp-compute-spectrum-feats": vad_tools.compute_spectrum_feats,
    # aslp-vadbin
    "aslp-apply-energy-vad": vad_tools.apply_energy_vad,
    "aslp-apply-nnet-vad": vad_tools.apply_nnet_vad,
    "aslp-apply-nn-vad": vad_tools.apply_nnet_vad,
    "aslp-apply-nn-vad-frame": vad_tools.apply_nnet_vad,
    "aslp-apply-nn-vad-segment": vad_tools.apply_nnet_vad_segment,
    "aslp-apply-gmm-vad": vad_tools.apply_gmm_vad,
    "gmm-global-init-from-feats": vad_tools.gmm_global_init_from_feats,
    "aslp-eval-vad": vad_tools.eval_vad_cli,
    "aslp-eval-energy-vad": vad_tools.eval_vad_cli,
    "aslp-eval-nn-vad": vad_tools.eval_vad_cli,
    "aslp-eval-gmm-vad": vad_tools.eval_gmm_vad_cli,
    "aslp-eval-vad-boundary": vad_tools.eval_vad_boundary_cli,
    "aslp-eval-nn-vad-boundary": vad_tools.eval_vad_boundary_cli,
    "aslp-ali-to-sil": vad_tools.ali_to_sil,
    "aslp-select-frames": vad_tools.select_frames_cli,
    # aslp-kwsbin / fst tools, aslp_scripts/kws
    "aslp-fst-init": fst_tools.fst_init,
    "aslp-fst-info": fst_tools.fst_info,
    "aslp-fst-to-dot": fst_tools.fst_to_dot,
    "aslp-kws-score": fst_tools.kws_score,
    "aslp-kws-gen-state-map": fst_tools.kws_gen_state_map,
    "aslp-kws-convert-phone-ali": fst_tools.kws_convert_phone_ali,
    "aslp-kws-evaluation-roc": fst_tools.kws_evaluation_roc,
    "aslp-kws-gen-text-fst": script_tools.kws_gen_text_fst,
    "aslp-kws-generate-simulation-ali":
        script_tools.kws_generate_simulation_ali,
    # aslp_scripts program-role helpers: log analysis, TextGrid
    "aslp-log-analyse": script_tools.log_analyse,
    "aslp-log-analyse-ctc": script_tools.log_analyse,
    "aslp-mpi-log-analyse": script_tools.mpi_log_analyse,
    "aslp-gen-textgrid": script_tools.gen_textgrid,
    # aslp_scripts/syllable
    "aslp-convert-lexicon-to-syllable":
        script_tools.convert_lexicon_to_syllable,
    "aslp-bind-syllable": script_tools.bind_syllable_cli,
    "aslp-bind-lexicon": script_tools.bind_lexicon_cli,
    "aslp-ali-to-syllable": script_tools.ali_to_syllable_cli,
    # aslp-bin augmentation
    "aslp-wav-noise": nnet_tools.wav_noise,
    # aslp-onlinebin server + client
    "aslp-online-nnet-vad-server": online_tools.online_nnet_vad_server,
    "aslp-online-energy-vad-server": online_tools.online_energy_vad_server,
    "aslp-audio-provider-client": online_tools.audio_provider_client,
    # aslp-nnetbin trainers
    "aslp-nnet-train-simple": train_tools.nnet_train_simple,
    "aslp-nnet-train-mse": train_tools.nnet_train_simple,
    "aslp-nnet-train-frame": train_tools.nnet_train_simple,
    "aslp-nnet-train-frame-mimo": train_tools.nnet_train_frame_mimo,
    "aslp-nnet-train-ctc-streams": train_tools.nnet_train_ctc_streams,
    # warp-ctc role is folded into the one CTC loss, as in the JAX package
    "aslp-nnet-train-warp-ctc-streams": train_tools.nnet_train_ctc_streams,
    "aslp-nnet-train-ctc": train_tools.nnet_train_ctc_streams,
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
    "aslp-nnet-forward-mimo": nnet_tools.nnet_forward_mimo,
    # aslp-nnetbin model tools
    "aslp-nnet-init": nnet_tools.nnet_init,
    "aslp-nnet-info": nnet_tools.nnet_info,
    "aslp-nnet-copy": nnet_tools.nnet_copy,
    "aslp-nnet-dot": nnet_tools.nnet_dot,
    "aslp-nnet-insert": nnet_tools.nnet_insert,
    "aslp-nnet-convert-to-standard": nnet_tools.nnet_convert_to_standard,
    # bin / aslp-bin alignment and matrix tools
    "ali-to-pdf": nnet_tools.ali_to_pdf,
    "aslp-ali-to-pdf": nnet_tools.ali_to_pdf,
    "aslp-ali-minus-one": nnet_tools.ali_minus_one,
    "analyze-counts": nnet_tools.analyze_counts,
    "aslp-ali-to-matrix": nnet_tools.ali_to_matrix,
    "aslp-matrix-to-txt": nnet_tools.matrix_to_txt,
    "aslp-txt-to-matrix": nnet_tools.txt_to_matrix,
    "aslp-copy-vector-from-matrix": nnet_tools.copy_vector_from_matrix,
    "aslp-extract-transition-to-pdf": nnet_tools.extract_transition_to_pdf,
    # latbin, bin
    "lattice-best-path": lat_tools.lattice_best_path_cli,
    "lattice-scale": lat_tools.lattice_scale_cli,
    "lattice-copy": lat_tools.lattice_copy_cli,
    "lattice-determinize": lat_tools.lattice_determinize_cli,
    "lattice-lmrescore": lat_tools.lattice_lmrescore_cli,
    "latgen-faster-mapped": lat_tools.latgen_faster_mapped_cli,
    "aslp-latgen-faster-rtf": lat_tools.latgen_faster_rtf_cli,
    "compute-wer": nnet_tools.compute_wer,
    # aslp-bin CD-phone prep family
    "aslp-acc-tree-stats-cd-phone-equal":
        tree_tools.acc_tree_stats_cd_phone_equal,
    "aslp-acc-tree-stats-cd-phone-kmeans":
        tree_tools.acc_tree_stats_cd_phone_kmeans,
    "aslp-acc-tree-stats-cd-phone-viterbi":
        tree_tools.acc_tree_stats_cd_phone_viterbi,
    "aslp-acc-tree-stats-phone-mean": tree_tools.acc_tree_stats_phone_mean,
    "aslp-acc-tree-stats-phone-mean-per-frame":
        tree_tools.acc_tree_stats_phone_mean_per_frame,
    "aslp-acc-tree-stats-phone-median":
        tree_tools.acc_tree_stats_phone_median,
    "aslp-compile-questions-phone": tree_tools.compile_questions_phone_cli,
    "aslp-tree-bind-info": tree_tools.tree_bind_info_cli,
    "aslp-cluster-kmeans-cd-phone-test":
        tree_tools.cluster_kmeans_cd_phone_test_cli,
    "aslp-convert-ali": tree_tools.convert_ali_cli,
    "aslp-make-ctc-transducer": tree_tools.make_ctc_transducer_cli,
    "aslp-make-h3-transducer": tree_tools.make_h3_transducer_cli,
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
