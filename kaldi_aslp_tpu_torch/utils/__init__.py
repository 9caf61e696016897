"""Config, logging, profiling and device helpers (port of
kaldi_aslp_tpu/utils/)."""

from kaldi_aslp_tpu_torch.utils.log import get_logger, set_verbose_level
from kaldi_aslp_tpu_torch.utils.config import (
    Config,
    ConfigError,
    parse_options,
)
from kaldi_aslp_tpu_torch.utils.profile import AccuProfiler, ThroughputMeter
