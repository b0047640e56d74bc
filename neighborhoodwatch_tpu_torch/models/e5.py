"""e5 embedding generator (counterpart of models/e5_flax.py): the BERT
encoder of models/bert.py + mean pooling + L2 normalization.

Replaces the reference's SentenceTransformer path (reference:
model_generator.py:273-287). Sequences are padded to the tokenizer's
power-of-two buckets and a ragged tail chunk to the full 64 rows (as
e5_flax.py pads it), matmuls run in the config's activation dtype (bf16
for the e5 configs), pooling and normalization in fp32. On the card the
forward and the pooling run as one captured CUDA graph per token bucket
(models/graphed.py, the counterpart of the reference's jax.jit). The
"query:" prefix contract is inherited from the generator ABC.

Weights come from a locally cached HuggingFace checkpoint when there is
one, else from a seeded random init (`pretrained` says which); carry the
JAX package's weights across with models.bert.bert_state_from_flax.

The same generator serves the decoder embedder e5-mistral-7b-instruct
(models/decoder.py): its forward in place of BERT's, last-token pooling in
place of the mean, BOS / EOS around each text, texts cut at the model
card's 4,096 tokens and buckets from 64, the card's instruction before
queries (`dataset_type="query"`) and nothing before documents. Its
weights: a state_dict adopted on the device as it is (no copy), the cached
checkpoint, or a seeded init drawn on the device.
"""

import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.models import decoder as dec
from neighborhoodwatch_tpu_torch.models.bert import (
    BertEncoder, E5_CONFIGS, init_params, load_hf_weights,
    mean_pool_normalize,
)
from neighborhoodwatch_tpu_torch.models.generators import EmbeddingGenerator
from neighborhoodwatch_tpu_torch.models.graphed import (
    GraphError, GraphRunner, pad_rows,
)
from neighborhoodwatch_tpu_torch.models.registry import EmbeddingModelName
from neighborhoodwatch_tpu_torch.models.tokenizer import (
    load_tokenizer, token_buckets,
)
from neighborhoodwatch_tpu_torch.utils.profiling import span


class E5EmbeddingGenerator(EmbeddingGenerator):
    """`state` is a BertEncoder (DecoderEncoder for e5-mistral) state_dict;
    None loads the cached checkpoint, else a seeded random init.
    `max_length` None is the model's limit (512; e5-mistral's card 4,096).
    `dataset_type` "query" puts e5-mistral's instruction before each text.
    `device=None` means "cuda" and raises without a card."""

    def __init__(self, model_name=EmbeddingModelName.INTFLOAT_E5_BASE_V2.value,
                 max_length: int | None = None, state=None, seed: int = 0,
                 device=None, dataset_type=None):
        decoder = model_name in dec.DECODER_CONFIGS
        assert model_name in E5_CONFIGS or decoder, \
            f"{model_name} is not an e5 model"
        super().__init__(model_name=model_name, chunk_size=64)
        self.dataset_type = dataset_type
        self.device = resolve_device(device)
        self.tokens_seen = 0       # pipeline-level tokens/s accounting
        if decoder:
            self.config = dec.DECODER_CONFIGS[model_name]
            self.max_length = max_length or dec.MAX_LENGTH
            if self.max_length % 64 or not 64 <= self.max_length \
                    <= dec.MAX_LENGTH:
                raise ValueError(f"{model_name}: max_length "
                                 f"{self.max_length} is no multiple of 64 "
                                 f"in 64 .. {dec.MAX_LENGTH}")
            self.tokenizer = load_tokenizer(model_name, decoder=self.config)
            if state is None:
                state = dec.load_hf_weights(model_name, self.config)
            self.model, self.pretrained = dec.build_decoder(
                self.config, state, seed, self.device, self.max_length)
            pool = dec.last_token_normalize
            buckets = token_buckets(self.max_length, min_bucket=64)
        else:
            self.config = E5_CONFIGS[model_name]
            self.max_length = max_length or 512
            self.tokenizer = load_tokenizer(model_name)
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
            pool = mean_pool_normalize
            buckets = token_buckets(self.max_length)
        model = self.model

        def forward(ids, mask):
            return pool(model(ids, mask), mask)
        # every chunk is padded to chunk_size rows: one graph per bucket
        self.runner = GraphRunner(forward, self.device, len(buckets),
                                  name=model_name)

    def _encode(self, chunk):
        """Tokenize and launch one chunk, a ragged one padded to chunk_size
        rows; returns its (rows, dim) fp32 embeddings on the device (not
        synchronized), the pad rows dropped. Under a recording profiler:
        the span `e5.chunk`, from tokenizing (`e5.tokenize`) to the forward
        issued."""
        with span("e5.chunk"):
            with span("e5.tokenize"):
                ids, mask = self.tokenizer(chunk, max_length=self.max_length)
            self.tokens_seen += int(mask.sum())
            rows = ids.shape[0]
            ids, mask = pad_rows(ids, mask, self.chunk_size)
            return self.runner(ids, mask, rows)

    def _call_model_api(self, text_list, *args, **kwargs):
        return self._encode(text_list).cpu().numpy()

    def generate_embedding(self, text_list, *args, **kwargs):
        """ABC-contract override with a deferred readback: every chunk is
        launched first (graph replays fed by copies that do not block, so
        tokenizing chunk i+1 overlaps the encode of chunk i), then the
        successful chunks' outputs are concatenated on the device and
        copied to the host in ONE transfer. A chunk whose tokenize or
        launch fails gives zero vectors for its rows only; an
        AssertionError (a caller's contract violation) passes through, as
        in the ABC's loop, and so does a GraphError: a failed capture or
        replay is a fault of the shape, which would zero every chunk of it.
        A failing copy raises: on the card it means a device fault, which
        no retry cures."""
        if isinstance(text_list, str):
            text_list = [text_list]
        pending = []            # (device tensor | None, row count)
        for chunk in self._iter_chunks(text_list):
            try:
                pending.append((self._encode(chunk), len(chunk)))
            except (AssertionError, GraphError):
                raise
            except Exception as exc:
                print(f"   !! embedding chunk failed ({exc}); "
                      f"emitting zero vectors for {len(chunk)} rows")
                pending.append((None, len(chunk)))
        with span("e5.readback"):
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
