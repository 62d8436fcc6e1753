"""Host-side data: sample types, conversation templates, tokenizer adapters,
the sample builder and collator, dataset registry and mixing, the resumable
batch streams, webdataset shards and filters, and the dataset catalog
(copies of the JAX package's JAX-free ``data/`` modules)."""

from dreamllm_tpu_torch.data.builder import BuilderConfig, DreamLLMBuilder
from dreamllm_tpu_torch.data.collator import collate
from dreamllm_tpu_torch.data.dataset_types import (
    ConversationSample,
    DatasetType,
    ImageTextPair,
    InstructInterleavedImageText,
    InterleavedImageText,
    Message,
)
from dreamllm_tpu_torch.data.mixed import MixedDataset
from dreamllm_tpu_torch.data.registry import DATASETS, DataManager, DatasetInfo

__all__ = ["BuilderConfig", "ConversationSample", "DATASETS", "DataManager", "DatasetInfo",
           "DatasetType", "DreamLLMBuilder", "ImageTextPair", "InstructInterleavedImageText",
           "InterleavedImageText", "Message", "MixedDataset", "collate"]
