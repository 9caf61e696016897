"""Components, the graph ``Nnet`` and model builders
(port of kaldi_aslp_tpu/models/).

Importing this package registers every ported component token (the JAX
registry's, token for token), so ``Nnet.load`` and ``Nnet.from_proto``
can build any model the JAX package can."""

from kaldi_aslp_tpu_torch.models.component import (
    Component,
    build_component,
    component_from_token,
    known_tokens,
    parse_proto_line,
    register,
)
from kaldi_aslp_tpu_torch.models.batchnorm import (
    BatchNormalization,
    merge_bn_stats,
)
from kaldi_aslp_tpu_torch.models.conv import (
    ConvolutionalComponent,
    MaxPoolingComponent,
)
from kaldi_aslp_tpu_torch.models.fsmn import CompactFsmn, RowConvolution
from kaldi_aslp_tpu_torch.models.losses import (
    LossReporter,
    MultiTaskSpec,
    ctc_batch_loss,
    ctc_loss_spike_mask,
    mse_loss,
    multitask_loss,
    xent_loss,
)
from kaldi_aslp_tpu_torch.models.nnet import Nnet, Node
from kaldi_aslp_tpu_torch.models.recurrent import (
    BLstm,
    BLstmProjectedStreams,
    BLstmProjectedStreamsLC,
    GruStreams,
    Lstm,
    LstmCifgProjectedStreams,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu_torch.models.simple import (
    AddShift,
    AffineTransform,
    BlockSoftmax,
    CopyComponent,
    Dropout,
    LengthNorm,
    LinearTransform,
    Maxout,
    Pnorm,
    ReLU,
    Rescale,
    Sigmoid,
    Softmax,
    Splice,
    Tanh,
    Transmit,
)
