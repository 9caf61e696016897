"""The port's HMM topologies and transition model
(kaldi_aslp_tpu_torch/hmm/) against the JAX package's kaldi_aslp_tpu/hmm/:
the same topology entries, transition ids, pdf and phone maps, MLE
update from the same counts and the copy of trained log-probabilities
between models.  Both are host numpy on the same integers, so everything
is compared for equality."""

import dataclasses

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.hmm import HmmTopology as JaxTopology
from kaldi_aslp_tpu.hmm import TransitionModel as JaxTransitionModel
from kaldi_aslp_tpu_torch.hmm import HmmTopology, TransitionModel

torch.set_num_threads(1)

PHONES = [1, 2, 3, 4, 5]
SIL = [5]


def _topos(kind):
    if kind == "default":
        return (HmmTopology.default(PHONES, sil_phones=SIL),
                JaxTopology.default(PHONES, sil_phones=SIL))
    if kind == "fake_min_duration":
        return (HmmTopology.fake_min_duration(PHONES, min_frames=3),
                JaxTopology.fake_min_duration(PHONES, min_frames=3))
    return (getattr(HmmTopology, kind)(PHONES),
            getattr(JaxTopology, kind)(PHONES))


def _pdf_map(topo):
    mapping, nxt = {}, 0
    for ph in topo.phones:
        for pc in range(topo.entry(ph).num_pdf_classes):
            mapping[(ph, pc)] = nxt
            nxt += 1
    return lambda phone, pdf_class: mapping[(phone, pdf_class)]


def _models(kind="default"):
    topo, jtopo = _topos(kind)
    return (TransitionModel(topo, _pdf_map(topo)),
            JaxTransitionModel(jtopo, _pdf_map(jtopo)))


@pytest.mark.parametrize("kind", ["default", "fake_ctc", "fake_min_duration",
                                  "fake_cd_phone"])
def test_topologies_match_jax(kind):
    topo, jtopo = _topos(kind)
    assert topo.phones == jtopo.phones == PHONES
    for ph in PHONES:
        got, want = topo.entry(ph), jtopo.entry(ph)
        assert [dataclasses.astuple(s) for s in got.states] == \
            [dataclasses.astuple(s) for s in want.states]
        assert (got.num_emitting, got.num_pdf_classes) == \
            (want.num_emitting, want.num_pdf_classes)
    if kind == "default":
        assert topo.entry(5).num_emitting == 4   # 5-state silence


@pytest.mark.parametrize("kind", ["default", "fake_ctc", "fake_cd_phone"])
def test_transition_ids_and_maps_match_jax(kind):
    tm, jtm = _models(kind)
    assert (tm.num_transition_ids, tm.num_pdfs) == \
        (jtm.num_transition_ids, jtm.num_pdfs)
    assert [dataclasses.astuple(s) for s in tm.states[1:]] == \
        [dataclasses.astuple(s) for s in jtm.states[1:]]
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    tids = np.arange(tm.num_transition_ids + 1)
    np.testing.assert_array_equal(tm.alignment_to_pdfs(tids),
                                  jtm.alignment_to_pdfs(tids))
    np.testing.assert_array_equal(tm.alignment_to_phones(tids[1:], False),
                                  jtm.alignment_to_phones(tids[1:], False))
    for tid in tids[1:]:
        assert tm.tid_to_arc(tid) == jtm.tid_to_arc(tid)
        assert tm.is_self_loop(tid) == jtm.is_self_loop(tid)
    rs = np.random.RandomState(3)
    ali = rs.randint(1, tm.num_transition_ids + 1, 60)
    np.testing.assert_array_equal(tm.alignment_to_phones(ali),
                                  jtm.alignment_to_phones(ali))
    for got, want in zip(tm.alignment_to_phone_pdfclass(ali),
                         jtm.alignment_to_phone_pdfclass(ali)):
        np.testing.assert_array_equal(got, want)


def test_triples_constructor_matches_jax():
    topo, jtopo = _topos("default")
    triples = [(ph, s, 10 * ph + s) for ph in PHONES
               for s in range(topo.entry(ph).num_emitting)]
    tm = TransitionModel(topo, triples=triples)
    jtm = JaxTransitionModel(jtopo, triples=triples)
    assert tm.num_pdfs == jtm.num_pdfs
    for ph, s, pdf in triples:
        assert tm.transition_state(ph, s, pdf) == \
            jtm.transition_state(ph, s, pdf)
    with pytest.raises(ValueError, match="pdf_map or triples"):
        TransitionModel(topo)


@pytest.mark.parametrize("floor", [0.01, 0.2])
def test_accumulate_and_mle_update_match_jax(floor):
    tm, jtm = _models()
    rs = np.random.RandomState(5)
    counts = jcounts = None
    for _ in range(4):
        ali = rs.randint(1, tm.num_transition_ids + 1, 80)
        counts = tm.accumulate(ali, counts)
        jcounts = jtm.accumulate(ali, jcounts)
    np.testing.assert_array_equal(counts, jcounts)
    tm.mle_update(counts, floor=floor)
    jtm.mle_update(jcounts, floor=floor)
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    assert not np.array_equal(tm.log_probs, _models()[0].log_probs)


def test_copy_log_probs_from_matches_jax():
    """The trained probabilities of every shared (phone, state, pdf)
    triple move into a fresh model; the others keep their priors."""
    tm, jtm = _models()
    rs = np.random.RandomState(9)
    ali = rs.randint(1, tm.num_transition_ids + 1, 200)
    tm.mle_update(tm.accumulate(ali))
    jtm.mle_update(jtm.accumulate(ali))
    topo, jtopo = _topos("default")
    triples = [(ph, s, pdf) for ph in PHONES
               for s in range(topo.entry(ph).num_emitting)
               for pdf in ((tm.states[tm.transition_state_of(ph, s)].pdf,)
                           if ph != 2 else (99,))]
    fresh = TransitionModel(topo, triples=triples)
    jfresh = JaxTransitionModel(jtopo, triples=triples)
    prior = fresh.log_probs.copy()
    fresh.copy_log_probs_from(tm)
    jfresh.copy_log_probs_from(jtm)
    np.testing.assert_array_equal(fresh.log_probs, jfresh.log_probs)
    moved = fresh.log_probs != prior
    # phone 2's triples name a pdf the trained model lacks: kept
    kept = [fresh.pair_to_tid(fresh.transition_state(2, s, 99), a)
            for s in range(3) for a in range(2)]
    assert moved.any() and not moved[kept].any()
