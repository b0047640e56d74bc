"""Embedding generator ABC (counterpart of models/generators.py; the
remote-API generators are not ported yet).

Capability parity with reference model_generator.py:156-213: chunked batch
embedding with zero-vector fallback on API failure, chunk_size <= 64
invariant, e5 "query:" prefixing.

Note: the reference applies the e5 "query:" prefix both in the ABC
(model_generator.py:194-195) and again in the dataset layer
(generate_dataset.py:62-63) — a double-prefix defect. Here it is applied
exactly once, in the ABC.
"""

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
