"""Embedding model registry (counterpart of models/registry.py): supported
model names and dimension tables.

Capability parity with the reference registry (model_generator.py:26-113):
same 15 model names, same default/effective dimension rules (OpenAI v3
reduced dims, Voyage 256/512/1024/2048). The generator factory and the
weight-cache probe of the `nw` banner are not ported yet; `ck` builds its
ColBERT generator directly.
"""

from enum import Enum


class EmbeddingModelName(Enum):
    OPENAI_ADA_002 = "text-embedding-ada-002"
    OPENAI_V3_SMALL = "text-embedding-3-small"
    OPENAI_V3_LARGE = "text-embedding-3-large"
    GOOGLE_TEXT_GECKO_003 = "textembedding-gecko@003"
    GOOGLE_TEXT_EMBEDDING_004 = "text-embedding-004"
    GOOGLE_TEXT_EMBEDDING_005 = "text-embedding-005"
    INTFLOAT_E5_LARGE_V2 = "intfloat/e5-large-v2"
    INTFLOAT_E5_BASE_V2 = "intfloat/e5-base-v2"
    INTFLOAT_E5_SMALL_V2 = "intfloat/e5-small-v2"
    NVIDIA_NEMO = "nvidia-nemo"
    COHERE_ENGLISH_V3 = "cohere/embed-english-v3.0"
    COHERE_ENGLISH_LIGHT_V3 = "cohere/embed-english-light-3.0"
    VOYAGE_3_LARGE = "voyage-3-large"
    VOYAGE_3_LITE = "voyage-3-lite"
    # per-token embedding model
    COLBERT_V2 = "colbertv2.0"


_DEFAULT_DIMENSIONS = {
    EmbeddingModelName.OPENAI_ADA_002: 1536,
    EmbeddingModelName.OPENAI_V3_SMALL: 1536,
    EmbeddingModelName.OPENAI_V3_LARGE: 3072,
    EmbeddingModelName.GOOGLE_TEXT_GECKO_003: 768,
    EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_004: 768,
    EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_005: 768,
    EmbeddingModelName.INTFLOAT_E5_LARGE_V2: 1024,
    EmbeddingModelName.INTFLOAT_E5_BASE_V2: 768,
    EmbeddingModelName.INTFLOAT_E5_SMALL_V2: 384,
    EmbeddingModelName.NVIDIA_NEMO: 1024,
    EmbeddingModelName.COHERE_ENGLISH_V3: 1024,
    EmbeddingModelName.COHERE_ENGLISH_LIGHT_V3: 384,
    EmbeddingModelName.VOYAGE_3_LARGE: 1024,
    EmbeddingModelName.VOYAGE_3_LITE: 512,
    EmbeddingModelName.COLBERT_V2: 128,
}


def get_valid_model_name_list():
    return [model.value for model in EmbeddingModelName]


def get_valid_model_names_string() -> str:
    return ", ".join(get_valid_model_name_list())


def is_valid_model_name(model_name) -> bool:
    return model_name is not None and model_name in get_valid_model_name_list()


def get_default_model_dimension_size(model_name: str) -> int:
    """(reference: model_generator.py:61-96)"""
    assert is_valid_model_name(model_name)
    return _DEFAULT_DIMENSIONS[EmbeddingModelName(model_name)]


def get_effective_embedding_size(model_name: str,
                                 output_dimension_size: int | None = None) -> int:
    """Models supporting reduced output dims: OpenAI v3 (any <= default) and
    Voyage-3-large (256/512/1024/2048); everyone else ignores the request
    (reference: model_generator.py:99-113)."""
    default_dimension_size = get_default_model_dimension_size(model_name)
    if output_dimension_size is None:
        return default_dimension_size
    if model_name in (EmbeddingModelName.OPENAI_V3_SMALL.value,
                      EmbeddingModelName.OPENAI_V3_LARGE.value):
        assert output_dimension_size <= default_dimension_size
        return output_dimension_size
    if model_name == EmbeddingModelName.VOYAGE_3_LARGE.value:
        assert output_dimension_size in (256, 512, 1024, 2048)
        return output_dimension_size
    return default_dimension_size


def colbert_weight_status(head_pretrained: bool,
                          backbone_pretrained: bool) -> str:
    """Provenance string from a ColBERT generator's LIVE load flags."""
    if head_pretrained:
        return "pretrained (colbertv2.0 backbone + projection head)"
    if backbone_pretrained:
        return ("pretrained backbone + RANDOM projection head "
                "— NOT ground truth")
    return "RANDOM INIT (no local checkpoint) — NOT ground truth"
