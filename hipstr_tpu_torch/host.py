"""The one bridge from the port into hipstr_tpu's JAX-free host code.

`hipstr_tpu.pipeline.genotyper` binds `compute_hap_log_likelihoods` from
`hipstr_tpu.pipeline.hap_aligner`, which imports JAX at its top; every
other module the port reuses (processor, genotyper, vcf_record, align/*,
io/*, models/*, native, utils/simulate) is free of JAX.  Unless JAX is
already loaded in this process, this module registers the port's own
`hipstr_tpu_torch.pipeline.hap_aligner` under the JAX module's name before
the first import of `hipstr_tpu.pipeline`, so the genotyper binds the
torch aligner (same signature) and the port never imports JAX, whether or
not JAX is installed.  Where JAX is already loaded (a JAX test session, a
program driving both packages) nothing is registered and the JAX package
keeps its own module.

Import this module before anything under `hipstr_tpu.pipeline`; in a
process without JAX loaded, import the JAX executor only after JAX.
"""

from __future__ import annotations

import sys

_JAX_ALIGNER = "hipstr_tpu.pipeline.hap_aligner"

if sys.modules.get("jax") is None and _JAX_ALIGNER not in sys.modules:
    from .pipeline import hap_aligner as _torch_aligner
    sys.modules[_JAX_ALIGNER] = _torch_aligner

from hipstr_tpu import native  # noqa: E402
from hipstr_tpu.cli import build_parser  # noqa: E402
from hipstr_tpu.io.regions import read_regions  # noqa: E402
from hipstr_tpu.io.vcf_write import VCFWriter, build_vcf_header  # noqa: E402
from hipstr_tpu.models.stutter import (StutterModel,  # noqa: E402
                                       write_stutter_models)
from hipstr_tpu.pipeline.processor import (GenotyperPipeline,  # noqa: E402
                                           Logger, PipelineOptions)
from hipstr_tpu.pipeline.vcf_record import (OutputConfig,  # noqa: E402
                                            build_vcf_record)

__all__ = [
    "GenotyperPipeline", "Logger", "OutputConfig", "PipelineOptions",
    "StutterModel", "VCFWriter", "build_parser", "build_vcf_header",
    "build_vcf_record", "native", "read_regions", "write_stutter_models",
]
