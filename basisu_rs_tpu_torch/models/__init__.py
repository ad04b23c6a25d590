"""Corpus-scale surfaces of the port: the corpus transcoders and the corpus
pipeline (counterparts of `basisu_rs_tpu/models/`)."""

from .pipeline import BasisCorpusPipeline, FileResult, PipelineState
from .transcoder import (
    CorpusTranscoder,
    Etc1sCorpusTranscoder,
    Etc1sFileWork,
    Etc1sMultiCorpusTranscoder,
    TranscodeResult,
    UastcTranscoder,
)

__all__ = [
    "BasisCorpusPipeline",
    "CorpusTranscoder",
    "Etc1sCorpusTranscoder",
    "Etc1sFileWork",
    "Etc1sMultiCorpusTranscoder",
    "FileResult",
    "PipelineState",
    "TranscodeResult",
    "UastcTranscoder",
]
