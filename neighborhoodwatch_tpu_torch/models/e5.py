"""e5 embedding generator (counterpart of models/e5_flax.py): the BERT
encoder of models/bert.py + mean pooling + L2 normalization.

Replaces the reference's SentenceTransformer path (reference:
model_generator.py:273-287). Sequences are padded to the tokenizer's
power-of-two buckets, matmuls run in the config's activation dtype (bf16
for the e5 configs), pooling and normalization in fp32. The "query:"
prefix contract is inherited from the generator ABC.

Weights come from a locally cached HuggingFace checkpoint when there is
one, else from a seeded random init (`pretrained` says which); carry the
JAX package's weights across with models.bert.bert_state_from_flax.
"""

import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.models.bert import (
    BertEncoder, E5_CONFIGS, init_params, load_hf_weights,
    mean_pool_normalize,
)
from neighborhoodwatch_tpu_torch.models.generators import EmbeddingGenerator
from neighborhoodwatch_tpu_torch.models.registry import EmbeddingModelName
from neighborhoodwatch_tpu_torch.models.tokenizer import load_tokenizer


class E5EmbeddingGenerator(EmbeddingGenerator):
    """`state` is a BertEncoder state_dict; None loads the cached
    checkpoint, else a seeded random init. `device=None` means "cuda" and
    raises without a card."""

    def __init__(self, model_name=EmbeddingModelName.INTFLOAT_E5_BASE_V2.value,
                 max_length: int = 512, state=None, seed: int = 0,
                 device=None):
        assert model_name in E5_CONFIGS, f"{model_name} is not an e5 model"
        super().__init__(model_name=model_name, chunk_size=64)
        self.device = resolve_device(device)
        self.config = E5_CONFIGS[model_name]
        self.max_length = max_length
        self.tokenizer = load_tokenizer(model_name)
        self.tokens_seen = 0       # pipeline-level tokens/s accounting
        self.model = BertEncoder(self.config)
        if state is None:
            state = load_hf_weights(model_name, self.config)
        if state is None:
            init_params(self.model, seed)
            self.pretrained = False
        else:
            self.model.load_state_dict(state)
            self.pretrained = True
        self.model.to(self.device).eval()

    @torch.no_grad()
    def _encode(self, chunk):
        """Tokenize and launch one chunk; returns its (rows, dim) fp32
        embeddings on the device (not synchronized)."""
        ids, mask = self.tokenizer(chunk, max_length=self.max_length)
        self.tokens_seen += int(mask.sum())
        ids = torch.from_numpy(ids).to(self.device, torch.long)
        mask = torch.from_numpy(mask).to(self.device)
        return mean_pool_normalize(self.model(ids, mask), mask)

    def _call_model_api(self, text_list, *args, **kwargs):
        return self._encode(text_list).cpu().numpy()

    def generate_embedding(self, text_list, *args, **kwargs):
        """ABC-contract override with a deferred readback: every chunk is
        launched first (CUDA launches are asynchronous, so tokenizing chunk
        i+1 overlaps the encode of chunk i), then the successful chunks'
        outputs are concatenated on the device and copied to the host in
        ONE transfer. A chunk whose tokenize or launch fails gives zero
        vectors for its rows only; an AssertionError (a caller's contract
        violation) passes through, as in the ABC's loop. A failing copy
        raises: on the card it means a device fault, which no retry
        cures."""
        if isinstance(text_list, str):
            text_list = [text_list]
        pending = []            # (device tensor | None, row count)
        for chunk in self._iter_chunks(text_list):
            try:
                pending.append((self._encode(chunk), len(chunk)))
            except AssertionError:
                raise
            except Exception as exc:
                print(f"   !! embedding chunk failed ({exc}); "
                      f"emitting zero vectors for {len(chunk)} rows")
                pending.append((None, len(chunk)))
        done = [dev for dev, _ in pending if dev is not None]
        host = torch.cat(done).cpu().numpy() if done else None
        embeddings, off = [], 0
        for dev, n in pending:
            if dev is None:
                embeddings.extend([self._zero_fallback()] * n)
            else:
                embeddings.extend(host[off:off + n])
                off += n
        return embeddings
