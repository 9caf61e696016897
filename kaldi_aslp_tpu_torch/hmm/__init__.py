"""HMM topologies and the transition model (port of
kaldi_aslp_tpu/hmm/topology.py and transition_model.py; numpy)."""

from kaldi_aslp_tpu_torch.hmm.topology import (
    HmmState,
    HmmTopology,
    TopologyEntry,
)
from kaldi_aslp_tpu_torch.hmm.transition_model import (
    TransitionModel,
    TransitionState,
)
