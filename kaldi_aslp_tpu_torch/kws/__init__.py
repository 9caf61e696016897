"""Keyword spotting (port of kaldi_aslp_tpu/kws/): the keyword-filler
spotter, the state map, phone-alignment conversion, the ROC sweep and
the keyword-filler text FST."""

from kaldi_aslp_tpu_torch.kws.kws import (
    KwsOptions,
    KeywordResult,
    KeywordSpotter,
)
from kaldi_aslp_tpu_torch.kws.state_map import (
    KwsStateMap,
    convert_phone_ali,
    gen_state_map,
    read_phone_map,
    roc_sweep,
    write_state_map,
)
