"""Shared decode + score helper for recipes: beam lattice decode with an
LMWT sweep, decode failures folded in as deletions.

Port of kaldi_aslp_tpu/recipes/score_util.py (``_decode_set``,
``_sweep_with_failures``, ``decode_wer_beam``, ``decode_wer_dev_test``;
reference: aslp_scripts/aslp_nnet/decode.sh latgen + score_basic.sh:49-80
sweep).  ``decode_wer_dev_test`` sweeps LMWT on a dev set and reports
the test set once at the dev-selected LMWT (the egs/timit/s5 dev/test
discipline); ``decode_wer_beam`` sweeps and reports on one set.

The decoder runs on ``device`` (default the card).  Only the decoder's
own "no path" errors (``DecodeError``, of which ``LatticeError`` is one:
no complete path, an empty lattice) score as deletions; the JAX module
catches every ``RuntimeError``, which would also turn a fault of the
card into deletions."""

from __future__ import annotations

import time
from typing import Dict, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.lattice import (
    LatticeError,
    score_lmwt_sweep,
)
from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("score")


def _decode_set(dec: BeamSearchDecoder, ll_set: Dict[str, np.ndarray],
                lattice_beam: float) -> Tuple[Dict, list, float, float]:
    """Lattice-decode every utterance; the ones with no path are
    collected (scored as full deletions by ``_sweep_with_failures``)."""
    lats: Dict[str, object] = {}
    failed = []
    t_dec = t_audio = 0.0
    for u, ll in sorted(ll_set.items()):
        t0 = time.time()
        try:
            _, _, _, lat = dec.decode_lattice(ll, lattice_beam=lattice_beam)
            if not lat.arcs:
                raise LatticeError("empty lattice")
            lats[u] = lat
        except DecodeError:
            failed.append(u)
        t_dec += time.time() - t0
        t_audio += len(ll) * 0.01
    if failed:
        logger.warning("decode failed (no path within beam) on %d "
                       "utts: %s", len(failed), failed[:5])
    return lats, failed, t_dec, t_audio


def _sweep_with_failures(lats: Dict, refs: Dict[str, list], failed: list,
                         lmwt_range) -> Dict:
    sweep = score_lmwt_sweep(lats, {u: refs[u] for u in lats},
                             lmwt_range=lmwt_range,
                             acoustic_scale_base=1.0)
    if failed:
        extra = score_utterances({u: refs[u] for u in failed},
                                 {u: [] for u in failed})
        for st in sweep.values():
            st.deletions += extra.deletions
            st.ref_length += extra.ref_length
            st.num_sentences += extra.num_sentences
            st.num_wrong_sentences += extra.num_wrong_sentences
    return sweep


def decode_wer_beam(packed, lut, test_ll: Dict[str, np.ndarray],
                    refs: Dict[str, list], acoustic_scale: float,
                    lmwt_range, beam: float = 16.0,
                    max_active: int = 2048, lattice_beam: float = 8.0,
                    chunk: int = 128,
                    device: Union[str, torch.device, None] = None
                    ) -> Tuple[float, Dict]:
    """Beam-lattice decode + LMWT sweep; returns (best WER, sweep).
    It selects LMWT on the set it scores: use it only where no dev
    split exists (or for dev-side sweeps)."""
    dec = BeamSearchDecoder(CsrGraph.from_packed(packed), lut,
                            acoustic_scale=acoustic_scale, beam=beam,
                            max_active=max_active, chunk=chunk,
                            device=device)
    lats, failed, t_dec, t_audio = _decode_set(dec, test_ll, lattice_beam)
    sweep = _sweep_with_failures(lats, refs, failed, lmwt_range)
    best_lmwt = min(sweep, key=lambda k: sweep[k].wer)
    logger.info("decode RTF %.3f; best LMWT %s", t_dec / max(t_audio, 1e-9),
                best_lmwt)
    return sweep[best_lmwt].wer, sweep


def decode_wer_dev_test(packed, lut,
                        dev_ll: Dict[str, np.ndarray],
                        dev_refs: Dict[str, list],
                        test_ll: Dict[str, np.ndarray],
                        test_refs: Dict[str, list],
                        acoustic_scale: float, lmwt_range,
                        beam: float = 16.0, max_active: int = 2048,
                        lattice_beam: float = 8.0, chunk: int = 128,
                        device: Union[str, torch.device, None] = None
                        ) -> Tuple[float, float, int]:
    """Sweep LMWT on dev, score test once at the dev-selected LMWT.
    Returns (test_wer, dev_wer, best_lmwt)."""
    dec = BeamSearchDecoder(CsrGraph.from_packed(packed), lut,
                            acoustic_scale=acoustic_scale, beam=beam,
                            max_active=max_active, chunk=chunk,
                            device=device)
    dlats, dfailed, _, _ = _decode_set(dec, dev_ll, lattice_beam)
    dsweep = _sweep_with_failures(dlats, dev_refs, dfailed, lmwt_range)
    best_lmwt = min(dsweep, key=lambda k: dsweep[k].wer)
    dev_wer = dsweep[best_lmwt].wer

    tlats, tfailed, t_dec, t_audio = _decode_set(dec, test_ll,
                                                 lattice_beam)
    tsweep = _sweep_with_failures(tlats, test_refs, tfailed,
                                  [best_lmwt])
    test_wer = tsweep[best_lmwt].wer
    logger.info("dev-selected LMWT %s: dev WER %.2f, test WER %.2f "
                "(test decode RTF %.3f)", best_lmwt, dev_wer, test_wer,
                t_dec / max(t_audio, 1e-9))
    return test_wer, dev_wer, best_lmwt
