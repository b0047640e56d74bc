"""Embedding model registry (counterpart of models/registry.py): supported
model names, dimension tables, and the generator factory.

Capability parity with the reference registry (model_generator.py:26-153):
the same 15 model names, same default/effective dimension rules (OpenAI v3
reduced dims, Voyage 256/512/1024/2048), same factory dispatch; and a
16th the reference lacks, intfloat/e5-mistral-7b-instruct (4096 dims, the
decoder embedder of models/decoder.py). Local models (e5 family,
ColBERT) are served by the PyTorch encoders of this package on `device`;
remote API models are plain HTTP clients.
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
    # decoder embedder (the port's own; not in the reference)
    INTFLOAT_E5_MISTRAL_7B = "intfloat/e5-mistral-7b-instruct"


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
    EmbeddingModelName.INTFLOAT_E5_MISTRAL_7B: 4096,
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


def get_embedding_generator_for_model(model_name, output_dimension=None,
                                      dataset_type=None, output_dtype=None,
                                      device=None):
    """Factory (reference: model_generator.py:116-153). `device` goes to
    the local encoders (None = "cuda"). Imported lazily so remote-client
    modules aren't required for local compute paths."""
    from neighborhoodwatch_tpu_torch.models import generators as g

    assert is_valid_model_name(model_name)
    m = EmbeddingModelName(model_name)
    if m == EmbeddingModelName.OPENAI_ADA_002:
        return g.OpenAIEmbeddingGenerator(model_name=model_name)
    if m in (EmbeddingModelName.OPENAI_V3_SMALL, EmbeddingModelName.OPENAI_V3_LARGE):
        return g.OpenAIEmbeddingGenerator(model_name=model_name,
                                          output_dimension_size=output_dimension)
    if m in (EmbeddingModelName.GOOGLE_TEXT_GECKO_003,
             EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_004,
             EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_005):
        return g.VertexAIEmbeddingGenerator(model_name=model_name)
    if m in (EmbeddingModelName.INTFLOAT_E5_SMALL_V2,
             EmbeddingModelName.INTFLOAT_E5_BASE_V2,
             EmbeddingModelName.INTFLOAT_E5_LARGE_V2,
             EmbeddingModelName.INTFLOAT_E5_MISTRAL_7B):
        from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
        return E5EmbeddingGenerator(model_name=model_name, device=device,
                                    dataset_type=dataset_type)
    if m == EmbeddingModelName.COLBERT_V2:
        from neighborhoodwatch_tpu_torch.models.colbert import ColbertEmbeddingGenerator
        return ColbertEmbeddingGenerator(device=device)
    if m == EmbeddingModelName.NVIDIA_NEMO:
        return g.NvidiaNemoEmbeddingGenerator(model_name=model_name)
    if m in (EmbeddingModelName.COHERE_ENGLISH_V3,
             EmbeddingModelName.COHERE_ENGLISH_LIGHT_V3):
        return g.CohereEmbeddingV3Generator(model_name=model_name)
    if m == EmbeddingModelName.VOYAGE_3_LARGE:
        return g.VoyageAIEmbeddingGenerator(model_name=model_name,
                                            input_type=dataset_type,
                                            output_dtype=output_dtype,
                                            output_dimension_size=output_dimension)
    if m == EmbeddingModelName.VOYAGE_3_LITE:
        return g.VoyageAIEmbeddingGenerator(model_name=model_name,
                                            input_type=dataset_type,
                                            output_dtype=output_dtype)
    return None


def colbert_weight_status(head_pretrained: bool,
                          backbone_pretrained: bool) -> str:
    """Provenance string from a ColBERT generator's LIVE load flags."""
    if head_pretrained:
        return "pretrained (colbertv2.0 backbone + projection head)"
    if backbone_pretrained:
        return ("pretrained backbone + RANDOM projection head "
                "— NOT ground truth")
    return "RANDOM INIT (no local checkpoint) — NOT ground truth"


def local_weight_status(model_name: str) -> str:
    """Weight provenance for the CLI banner. The local encoders (e5,
    ColBERT) fall back to a seeded random init when no checkpoint is
    cached: pipeline-valid but NOT ground truth, so the CLIs say so up
    front.

    Checks what a load would actually use: the weights file itself (not
    just config.json) and the loader's needs. e5 loads through
    transformers' AutoModel and needs config.json too; ColBERT reads
    model.safetensors through `safetensors`, or a .bin cache through
    torch."""
    def cached(repo, fname="config.json"):
        try:
            from transformers.utils import hub
            return isinstance(hub.try_to_load_from_cache(repo, fname), str)
        except Exception:
            return False

    def weights_cached(repo):
        # single-file checkpoints plus the sharded-layout index files
        return (cached(repo, "model.safetensors")
                or cached(repo, "pytorch_model.bin")
                or cached(repo, "model.safetensors.index.json")
                or cached(repo, "pytorch_model.bin.index.json"))

    if "e5" in model_name:
        if weights_cached(model_name) and cached(model_name):
            return f"pretrained ({model_name}, local HF cache)"
        return "RANDOM INIT (no local checkpoint) — NOT ground truth"

    def safetensors_ok():
        try:
            import safetensors  # noqa: F401
            return True
        except ImportError:
            return False

    if model_name == EmbeddingModelName.COLBERT_V2.value:
        # models.colbert.load_colbert_hf_weights: safetensors first, then
        # the .bin through torch
        repo = "colbert-ir/colbertv2.0"
        head = (cached(repo, "model.safetensors") and safetensors_ok()) \
            or cached(repo, "pytorch_model.bin")
        if not head and weights_cached(repo):
            return ("cached checkpoint but torch/safetensors unavailable "
                    "-> RANDOM INIT — NOT ground truth")
        return colbert_weight_status(
            head_pretrained=head,
            backbone_pretrained=weights_cached("bert-base-uncased")
            and cached("bert-base-uncased"))
    return "remote API (weights server-side)"
