"""Online serving (port of kaldi_aslp_tpu/online/): streaming features,
endpointing, the TCP decode server, VAD-gated sessions, CRF punctuation
and cross-session acoustic batching."""

from kaldi_aslp_tpu_torch.online.feature_pipeline import (
    OnlineFeatureOptions,
    OnlineFeaturePipeline,
)
from kaldi_aslp_tpu_torch.online.endpoint import (
    OnlineEndpointConfig,
    EndpointRule,
    endpoint_detected,
)
from kaldi_aslp_tpu_torch.online.server import (
    DecodeSession,
    OnlineServerOptions,
    OnlineTcpServer,
)
from kaldi_aslp_tpu_torch.online.vad_pipeline import OnlineVadFeaturePipeline
from kaldi_aslp_tpu_torch.online.vad_session import VadDecodeSession
from kaldi_aslp_tpu_torch.online.punctuation import (
    PunctuationProcessor,
    token_features,
)
from kaldi_aslp_tpu_torch.online.batching import (
    AcousticBatcher,
    BatchedDecodeSession,
)
