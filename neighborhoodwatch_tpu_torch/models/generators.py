"""Embedding generator ABC + remote-API generators (counterpart of
models/generators.py).

Capability parity with reference model_generator.py:156-389: chunked batch
embedding with zero-vector fallback on API failure, chunk_size <= 64
invariant, e5 "query:" prefixing, Cohere input_type and Voyage
output_dtype/dimension handling. Where the reference wraps vendor SDKs
(openai/cohere/voyageai/vertexai), these are REST calls through the
standard library's `urllib` with an injectable `transport` hook, so they
unit-test without a network.

Note: the reference applies the e5 "query:" prefix both in the ABC
(model_generator.py:194-195) and again in the dataset layer
(generate_dataset.py:62-63) — a double-prefix defect. Here it is applied
exactly once, in the ABC.
"""

import json
import os
import urllib.request
from abc import ABC, abstractmethod

import numpy as np

from neighborhoodwatch_tpu_torch.models.registry import (
    EmbeddingModelName, get_default_model_dimension_size,
    get_effective_embedding_size, get_valid_model_names_string,
    is_valid_model_name,
)


class EmbeddingGenerator(ABC):
    """Chunked batch embedding with per-chunk zero-vector fallback
    (reference: model_generator.py:156-213)."""

    def __init__(self, model_name: str, chunk_size: int,
                 output_dimension: int | None = None):
        self.model_name = model_name
        assert is_valid_model_name(self.model_name), \
            f"unknown embedding model {model_name!r}; supported: {get_valid_model_names_string()}"
        # Vendor APIs cap batch size (Cohere 96, Voyage 128, ...); the
        # reference standardizes on <= 64 (model_generator.py:168-169).
        if model_name != EmbeddingModelName.COLBERT_V2.value:
            assert chunk_size is not None and 0 < chunk_size <= 64
        self.model_dimension = get_default_model_dimension_size(self.model_name)
        self.output_dimension = get_effective_embedding_size(self.model_name,
                                                             output_dimension)
        self.chunk_size = chunk_size
        assert self.output_dimension is None or self.output_dimension > 0

    @property
    def dimensions(self) -> int:
        return self.output_dimension

    def _iter_chunks(self, texts):
        """Yield chunk_size-bounded slices, with the e5 "query:" prefix
        applied exactly once here (the reference applies it twice — in the
        ABC and again in the dataset layer; see module docstring)."""
        prefix = "query:" if "e5" in self.model_name else None
        for start in range(0, len(texts), self.chunk_size):
            chunk = texts[start:start + self.chunk_size]
            yield [prefix + t for t in chunk] if prefix else chunk

    def _zero_fallback(self):
        return np.zeros(self.output_dimension, dtype=np.float32)

    def generate_embedding(self, text_list, *args, **kwargs):
        if isinstance(text_list, str):
            text_list = [text_list]
        out = []
        for chunk in self._iter_chunks(text_list):
            try:
                out.extend(self._call_model_api(chunk, *args, **kwargs))
            except AssertionError:
                # contract violations are caller bugs, not transient API
                # failures: swallowing one (e.g. Cohere's input_type
                # requirement) emitted zero vectors for EVERY chunk and an
                # expensive run completed with an empty dataset and no
                # error exit
                raise
            except Exception as exc:
                print(f"   !! embedding chunk failed ({exc}); "
                      f"emitting zero vectors for {len(chunk)} rows")
                out.extend([self._zero_fallback()] * len(chunk))
        return out

    @abstractmethod
    def _call_model_api(self, text_list: list, *args, **kwargs):
        ...


def _require_env(var: str) -> str:
    value = os.getenv(var)
    if value is None:
        raise RuntimeError(f"'{var}' environment variable is not set!")
    return value


def _default_transport(url, payload, headers, timeout=120):
    """POST `payload` as JSON, return the decoded JSON reply; an HTTP error
    status raises (urllib.error.HTTPError)."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _bearer_transport(token):
    """The default transport with an `Authorization: Bearer` header."""
    return lambda u, p, h: _default_transport(
        u, p, {**h, "Authorization": f"Bearer {token}"})


class OpenAIEmbeddingGenerator(EmbeddingGenerator):
    """OpenAI embeddings REST client: ada-002 / 3-small / 3-large with
    reduced output dims for v3 (reference: model_generator.py:216-252)."""

    API_URL = "https://api.openai.com/v1/embeddings"

    def __init__(self, model_name=EmbeddingModelName.OPENAI_V3_SMALL.value,
                 output_dimension_size=None, transport=None):
        assert model_name in (EmbeddingModelName.OPENAI_ADA_002.value,
                              EmbeddingModelName.OPENAI_V3_SMALL.value,
                              EmbeddingModelName.OPENAI_V3_LARGE.value)
        super().__init__(model_name=model_name, chunk_size=64,
                         output_dimension=output_dimension_size)
        assert 0 < self.output_dimension <= self.model_dimension
        self._transport = transport or \
            _bearer_transport(_require_env("OPENAI_API_KEY"))

    def _call_model_api(self, text_list, *args, **kwargs):
        payload = {"input": text_list, "model": self.model_name}
        if self.model_name != EmbeddingModelName.OPENAI_ADA_002.value:
            payload["dimensions"] = self.output_dimension
        data = self._transport(self.API_URL, payload,
                               {"Content-Type": "application/json"})
        return [item["embedding"] for item in data["data"]]


class VertexAIEmbeddingGenerator(EmbeddingGenerator):
    """Google Vertex AI text-embedding REST client: gecko@003 /
    text-embedding-004/005 (reference: model_generator.py:255-270)."""

    def __init__(self, model_name=EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_005.value,
                 project=None, location="us-central1", transport=None):
        assert model_name in (EmbeddingModelName.GOOGLE_TEXT_GECKO_003.value,
                              EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_004.value,
                              EmbeddingModelName.GOOGLE_TEXT_EMBEDDING_005.value)
        super().__init__(model_name=model_name, chunk_size=64)
        self.location = location
        if transport is None:
            self.project = project or _require_env("GOOGLE_CLOUD_PROJECT")
            transport = _bearer_transport(_require_env("GOOGLE_ACCESS_TOKEN"))
        else:
            self.project = project or "test-project"
        self._transport = transport

    @property
    def api_url(self):
        return (f"https://{self.location}-aiplatform.googleapis.com/v1/projects/"
                f"{self.project}/locations/{self.location}/publishers/google/"
                f"models/{self.model_name}:predict")

    def _call_model_api(self, text_list, *args, **kwargs):
        payload = {"instances": [{"content": t} for t in text_list]}
        data = self._transport(self.api_url, payload,
                               {"Content-Type": "application/json"})
        return [pred["embeddings"]["values"] for pred in data["predictions"]]


class NvidiaNemoEmbeddingGenerator(EmbeddingGenerator):
    """Local NV-Embed-QA HTTP service client
    (reference: model_generator.py:290-313)."""

    def __init__(self, model_name=EmbeddingModelName.NVIDIA_NEMO.value,
                 embedding_srv_url="http://localhost:8080/v1/embeddings",
                 transport=None):
        assert model_name == EmbeddingModelName.NVIDIA_NEMO.value
        super().__init__(model_name=model_name, chunk_size=64)
        self.embedding_srv_url = embedding_srv_url
        self._transport = transport or _default_transport

    def _call_model_api(self, text_list, *args, **kwargs):
        payload = {"input": text_list, "model": "NV-Embed-QA",
                   "input_type": "passage"}
        data = self._transport(self.embedding_srv_url, payload,
                               {"Content-Type": "application/json",
                                "Accept": "application/json"})
        return [item["embedding"] for item in data["data"]]


class CohereEmbeddingV3Generator(EmbeddingGenerator):
    """Cohere embed-english-v3 REST client with required input_type
    (reference: model_generator.py:316-344)."""

    API_URL = "https://api.cohere.com/v1/embed"
    VALID_INPUT_TYPES = ("search_query", "search_document",
                         "classification", "clustering")

    def __init__(self, model_name=EmbeddingModelName.COHERE_ENGLISH_V3.value,
                 transport=None):
        assert model_name in (EmbeddingModelName.COHERE_ENGLISH_V3.value,
                              EmbeddingModelName.COHERE_ENGLISH_LIGHT_V3.value)
        super().__init__(model_name=model_name, chunk_size=64)
        self._transport = transport or \
            _bearer_transport(_require_env("COHERE_API_KEY"))
        # strip the leading "cohere/" for the API payload
        self.api_model_name = model_name.split("/")[1]

    def generate_embedding(self, text_list, *args, **kwargs):
        # validated here, outside the per-chunk zero fallback: a missing
        # input_type is a caller bug (swallowed per chunk it would finish
        # a run with an all-zero dataset), and a raise survives python -O
        if kwargs.get("input_type") not in self.VALID_INPUT_TYPES:
            raise ValueError(
                "input_type is required for Cohere embeddings and must be "
                "one of: " + ", ".join(self.VALID_INPUT_TYPES))
        return super().generate_embedding(text_list, *args, **kwargs)

    def _call_model_api(self, text_list, *args, **kwargs):
        input_type = kwargs.get("input_type")
        assert input_type in self.VALID_INPUT_TYPES, \
            ("input_type is required for Cohere embeddings and must be one of: "
             + ", ".join(self.VALID_INPUT_TYPES))
        payload = {"texts": text_list, "model": self.api_model_name,
                   "input_type": input_type}
        data = self._transport(self.API_URL, payload,
                               {"Content-Type": "application/json"})
        return np.array(data["embeddings"])


class VoyageAIEmbeddingGenerator(EmbeddingGenerator):
    """VoyageAI REST client: voyage-3-large/lite with output_dtype
    float/int8/uint8/binary/ubinary and dims 256/512/1024/2048
    (reference: model_generator.py:347-389)."""

    API_URL = "https://api.voyageai.com/v1/embeddings"

    def __init__(self, model_name="voyage-3-large", input_type="document",
                 output_dtype="float", output_dimension_size=None,
                 transport=None):
        assert model_name in (EmbeddingModelName.VOYAGE_3_LARGE.value,
                              EmbeddingModelName.VOYAGE_3_LITE.value)
        if input_type is None:
            input_type = "document"
        if output_dtype is None:
            output_dtype = "float"
        assert input_type in ("query", "document")
        if model_name == EmbeddingModelName.VOYAGE_3_LARGE.value:
            assert output_dimension_size is None or \
                output_dimension_size in (256, 512, 1024, 2048)
            assert output_dtype in ("float", "int8", "uint8", "binary", "ubinary")
        else:
            assert output_dtype in ("float",)
        super().__init__(model_name=model_name, chunk_size=64,
                         output_dimension=output_dimension_size)
        self.input_type = input_type
        self.output_dtype = output_dtype
        self._transport = transport or \
            _bearer_transport(_require_env("VOYAGE_API_KEY"))

    def _call_model_api(self, text_list, *args, **kwargs):
        payload = {"input": text_list, "model": self.model_name,
                   "input_type": self.input_type,
                   "output_dimension": self.output_dimension,
                   "output_dtype": self.output_dtype}
        data = self._transport(self.API_URL, payload,
                               {"Content-Type": "application/json"})
        return [item["embedding"] for item in data["data"]]
