"""Components, the graph ``Nnet`` and model builders
(port of kaldi_aslp_tpu/models/).

Importing this package registers every ported component token, so
``Nnet.load`` can build any model the port supports."""

from kaldi_aslp_tpu_torch.models.component import (
    Component,
    component_from_token,
    known_tokens,
    register,
)
from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.models.recurrent import (
    BLstm,
    BLstmProjectedStreams,
    Lstm,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu_torch.models.simple import (
    AffineTransform,
    Sigmoid,
    Softmax,
)
