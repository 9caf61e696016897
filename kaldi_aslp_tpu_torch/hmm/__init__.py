"""HMM topologies, the transition model and alignment conversion (port
of kaldi_aslp_tpu/hmm/; numpy)."""

from kaldi_aslp_tpu_torch.hmm.topology import (
    HmmState,
    HmmTopology,
    TopologyEntry,
)
from kaldi_aslp_tpu_torch.hmm.transition_model import (
    TransitionModel,
    TransitionState,
)
from kaldi_aslp_tpu_torch.hmm.convert_ali import (
    convert_alignment,
    phone_segments,
)
