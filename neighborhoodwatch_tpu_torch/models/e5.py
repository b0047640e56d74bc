"""e5 embedding generator (counterpart of models/e5_flax.py): the BERT
encoder of models/bert.py + mean pooling + L2 normalization.

Replaces the reference's SentenceTransformer path (reference:
model_generator.py:273-287). Sequences are padded to the tokenizer's
power-of-two buckets and every forward to the full 64 rows (as
e5_flax.py pads a ragged tail), matmuls run in the config's activation
dtype (bf16 for the e5 configs), pooling and normalization in fp32. The
e5-v2 encoders send a call's rows to the forwards by token bucket, not in
arrival order (`generate_embedding`), so that a forward pads few slots. On the card the
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

import numpy as np
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
from neighborhoodwatch_tpu_torch.utils.profiling import count, span


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
        self.decoder = decoder
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
        self.buckets = np.asarray(buckets)
        model = self.model

        def forward(ids, mask):
            return pool(model(ids, mask), mask)
        # every forward is padded to chunk_size rows: one graph per bucket
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
        """ABC-contract override with a deferred readback: every forward is
        launched first (graph replays fed by copies that do not block, so
        tokenizing the next 64 texts overlaps the encode of the last
        forward), then the outputs are put in the caller's order on the
        device and copied to the host in ONE transfer. The e5-v2 encoders
        group a call's rows by token bucket (`_grouped`); the decoder
        embedder runs its 64-text chunks in arrival order (`_in_order`).
        Texts whose tokenizing or forward fails give zero vectors; an
        AssertionError (a caller's contract violation) passes through, as
        in the ABC's loop, and so does a GraphError: a failed capture or
        replay is a fault of the shape, which would zero every forward of
        it. A failing copy raises: on the card it means a device fault,
        which no retry cures."""
        if isinstance(text_list, str):
            text_list = [text_list]
        if self.decoder:
            return self._in_order(text_list)
        return self._grouped(text_list)

    def _in_order(self, text_list):
        """One forward a 64-text chunk, in arrival order; a chunk whose
        tokenize or launch fails gives zero vectors for its rows only."""
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

    def _grouped(self, text_list):
        """Length-grouped forwards. Texts are tokenized in 64-text units in
        arrival order; each row goes, with its position in the call, into
        the queue of its own token bucket (`_pad`'s rule), and a queue
        that holds 64 rows is padded to (64, bucket) and launched at once.
        At the end of the call `_flush` packs the partial queues into
        ceil(rest / 64) forwards, rows moving up a bucket and never down,
        so a call issues ceil(n / 64) forwards with the fewest token slots
        any such packing has. A forward's rows go in call order; a call of
        at most 64 texts, or of one bucket, issues exactly the in-order
        chunks. A unit whose tokenizing fails gives zero vectors for its
        own rows, which are never queued; a forward that fails, for the
        rows it held. Under a recording profiler: the span `e5.chunk`
        around a unit's tokenizing (`e5.tokenize`) and the forwards it
        completes (the last unit's, the flush's too), and the counters
        `e5.forwards` (forwards issued) and `e5.promoted_rows` (rows the
        flush ran above their own bucket)."""
        n = len(text_list)
        queues = {int(b): [] for b in self.buckets}   # bucket -> blocks
        done = []                    # (positions, device tensor)
        last = -(-n // self.chunk_size) - 1
        for u, unit in enumerate(self._iter_chunks(text_list)):
            self._encode_unit(unit, u * self.chunk_size, queues, done,
                              u == last)
        with span("e5.readback"):
            if not done:
                return [self._zero_fallback()] * n
            out = torch.cat([dev for _, dev in done])
            pos = torch.from_numpy(np.concatenate([p for p, _ in done]))
            if out.is_cuda:
                pos = pos.pin_memory().to(out.device, non_blocking=True)
            full = out.new_zeros((n, out.shape[1]))
            full.index_copy_(0, pos, out)
            return list(full.cpu().numpy())

    def _encode_unit(self, unit, start, queues, done, last):
        """Tokenize one 64-text unit (its first text at call position
        `start`) into the queues, launching the forwards it completes, and
        with `last` flush the queues; the span `e5.chunk`."""
        with span("e5.chunk"):
            try:
                with span("e5.tokenize"):
                    ids, mask = self.tokenizer(unit,
                                               max_length=self.max_length)
            except AssertionError:
                raise
            except Exception as exc:
                print(f"   !! embedding chunk failed ({exc}); "
                      f"emitting zero vectors for {len(unit)} rows")
            else:
                self.tokens_seen += int(mask.sum())
                self._queue(queues, ids, mask, start, done)
            if last:
                self._flush(queues, done)

    def _queue(self, queues, ids, mask, start, done):
        """A tokenized unit's rows into their buckets' queues (blocks of
        (positions, ids, mask) cut to the bucket); every 64 rows a queue
        gathers are launched."""
        which = np.searchsorted(self.buckets, mask.sum(1))
        for k in np.unique(which):
            b = int(self.buckets[k])
            rows = np.flatnonzero(which == k)
            q = queues[b]
            q.append((start + rows, ids[rows, :b], mask[rows, :b]))
            if sum(len(p) for p, _, _ in q) >= self.chunk_size:
                pos, qi, qm = (np.concatenate(x) for x in zip(*q))
                c = self.chunk_size
                self._launch(pos[:c], qi[:c], qm[:c], done)
                q[:] = [(pos[c:], qi[c:], qm[c:])] if len(pos) > c else []

    def _flush(self, queues, done):
        """The partial queues, from the largest bucket down, into forwards
        of 64 rows: each forward is filled from the next smaller buckets'
        rows (in call order within a bucket), which run at its bucket; the
        last, partial forward holds the smallest rows."""
        group, room = [], self.chunk_size
        for b in sorted(queues, reverse=True):
            if not queues[b]:
                continue
            pos, ids, mask = (np.concatenate(x) for x in zip(*queues[b]))
            queues[b] = []
            while len(pos):
                take = min(room, len(pos))
                group.append((b, pos[:take], ids[:take], mask[:take]))
                pos, ids, mask = pos[take:], ids[take:], mask[take:]
                room -= take
                if not room:
                    self._launch_group(group, done)
                    group, room = [], self.chunk_size
        if group:
            self._launch_group(group, done)

    def _launch_group(self, group, done):
        """One flushed forward: its blocks [(bucket, positions, ids, mask)],
        the largest bucket first, padded to that bucket, rows in call
        order."""
        top = group[0][0]
        pos = np.concatenate([p for _, p, _, _ in group])
        ids = np.zeros((len(pos), top), np.int32)
        mask = np.zeros((len(pos), top), np.int32)
        at = 0
        for b, p, i, m in group:
            ids[at:at + len(p), :b] = i
            mask[at:at + len(p), :b] = m
            at += len(p)
        count("e5.promoted_rows",
              sum(len(p) for b, p, _, _ in group if b < top))
        order = np.argsort(pos, kind="stable")
        self._launch(pos[order], ids[order], mask[order], done)

    def _launch(self, pos, ids, mask, done):
        """One forward of the rows at call positions `pos`, padded to 64
        rows; a failure other than a contract violation or a GraphError
        leaves its rows' zero vectors."""
        count("e5.forwards", 1)
        try:
            ids, mask = pad_rows(ids, mask, self.chunk_size)
            done.append((pos, self.runner(ids, mask, len(pos))))
        except (AssertionError, GraphError):
            raise
        except Exception as exc:
            print(f"   !! embedding forward failed ({exc}); "
                  f"emitting zero vectors for {len(pos)} rows")
