"""Endpointing rules (reference: src/aslp-online/online-endpoint.{h,cc}
— OnlineEndpointConfig with 5 OR'd rules; each rule is a conjunction of
must-contain-nonsilence, min trailing silence, max relative final cost
and min utterance length, per online-endpoint.h:56-63 and the
RuleActivated conjunction in online-endpoint.cc:27-45).

Copy of kaldi_aslp_tpu/online/endpoint.py: that package's
``online/__init__`` loads JAX, so the port keeps its own."""

from __future__ import annotations

import dataclasses

from kaldi_aslp_tpu_torch.utils.config import Config

INF = float("inf")


@dataclasses.dataclass
class EndpointRule:
    """(reference: online-endpoint.h OnlineEndpointRule)."""
    must_contain_nonsilence: bool = True
    min_trailing_silence_s: float = 1.0
    max_relative_cost: float = INF
    min_utterance_length_s: float = 0.0

    def activated(self, trailing_silence_s: float, relative_cost: float,
                  utterance_length_s: float) -> bool:
        """(reference: online-endpoint.cc RuleActivated — nonsilence is
        inferred as utterance longer than its trailing silence)."""
        contains_nonsilence = utterance_length_s > trailing_silence_s
        return ((contains_nonsilence or not self.must_contain_nonsilence)
                and trailing_silence_s >= self.min_trailing_silence_s
                and relative_cost <= self.max_relative_cost
                and utterance_length_s >= self.min_utterance_length_s)


@dataclasses.dataclass
class OnlineEndpointConfig(Config):
    silence_phones: str = "1"
    frame_shift_s: float = 0.01
    # defaults mirror the reference's rule set
    # (online-endpoint.h:153-158):
    #   rule1: 5s of silence even if nothing was decoded
    #   rule2: 0.5s of silence, final state good (rel cost <= 2)
    #   rule3: 1.0s of silence, final state ok   (rel cost <= 8)
    #   rule4: 2.0s of silence regardless of final state
    #   rule5: utterance longer than 20s regardless of anything
    rule1_min_trailing_silence: float = 5.0
    rule2_min_trailing_silence: float = 0.5
    rule2_max_relative_cost: float = 2.0
    rule3_min_trailing_silence: float = 1.0
    rule3_max_relative_cost: float = 8.0
    rule4_min_trailing_silence: float = 2.0
    rule5_min_utterance_length: float = 20.0

    def rules(self) -> list:
        return [
            EndpointRule(False, self.rule1_min_trailing_silence),
            EndpointRule(True, self.rule2_min_trailing_silence,
                         self.rule2_max_relative_cost),
            EndpointRule(True, self.rule3_min_trailing_silence,
                         self.rule3_max_relative_cost),
            EndpointRule(True, self.rule4_min_trailing_silence),
            EndpointRule(False, 0.0, INF, self.rule5_min_utterance_length),
        ]


def endpoint_detected(
    config: OnlineEndpointConfig,
    num_frames_decoded: int,
    trailing_silence_frames: int,
    final_relative_cost: float = INF,
) -> bool:
    """(reference: online-endpoint.cc EndpointDetected).

    ``final_relative_cost`` is >= 0: 0 when a final state of the graph
    has the best score at the current frame, infinity when no final
    state is reachable (decoder.final_relative_cost())."""
    if num_frames_decoded == 0:
        return False
    utt_s = num_frames_decoded * config.frame_shift_s
    sil_s = trailing_silence_frames * config.frame_shift_s
    return any(rule.activated(sil_s, final_relative_cost, utt_s)
               for rule in config.rules())
