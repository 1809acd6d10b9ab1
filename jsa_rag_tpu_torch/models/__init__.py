from .bert import BERT_PRESETS, BertConfig, BertEncoder, pool  # noqa: F401
from .retriever import (  # noqa: F401
    DualEncoderRetriever,
    RetrieverConfig,
    l2_normalize,
)
