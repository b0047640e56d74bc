"""Driver of the decoder embedder's entry point,
`E5EmbeddingGenerator(model_name, state=..., dataset_type="document")
.generate_embedding(texts)` for e5-mistral-7b-instruct, as data/sources.py
calls it for base documents: each call a batch of texts made from (seed,
call), the embeddings returned on the host; the next call is issued when
the last returns (a closed loop of one client). The pattern of
drivers/encode.py, for a decoder: BOS and EOS around each text and no
prefix, buckets from 64 up to the model card's 4,096 tokens, the plain
reference reference/mistral.py.

The weights are made on the card from the seed (reference/mistral.py) and
handed to the generator (which adopts them without a copy) and to the
reference alike. Set-up captures the graph of every token bucket the mix
can reach (traffic/texts.py) and runs one call of the mix, and makes the
texts of the calls the window is expected to need, so that the window
holds only the embedder's calls. The check embeds a sample of the served
texts, drawn from the seed, with the longest of the window and a few rows
of each call's ragged last chunk (padded to a whole chunk by the
generator) among them, by the float32 reference, layer by layer over the
whole sample.
"""

import math
import time

import numpy as np
import torch

from nwbench import decoder_yardstick, seeds
from nwbench.reference import hash_tokenizer, mistral
from nwbench.trace import span

RAGGED_PER_CALL = 4
LEAST_BUCKET = 64
# the port's config fields that must equal the configuration's
_WIDTHS = (("hidden_size", "hidden_size"), ("num_layers", "num_hidden_layers"),
           ("num_heads", "num_attention_heads"),
           ("num_kv_heads", "num_key_value_heads"),
           ("intermediate_size", "intermediate_size"),
           ("vocab_size", "vocab_size"), ("rms_norm_eps", "rms_norm_eps"),
           ("rope_theta", "rope_theta"),
           ("max_position_embeddings", "max_position_embeddings"),
           ("bos_token_id", "bos_token_id"),
           ("eos_token_id", "eos_token_id"), ("dtype", "serving_dtype"))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.max_length = int(self.cfg["max_length"])
        self.attempted = self.failed = 0
        self.calls = 0
        self.texts, self.outputs = [], []
        self.extra = 2               # BOS and EOS; documents take no prefix

    def tokens(self, words) -> np.ndarray:
        return np.minimum(np.asarray(words) + self.extra, self.max_length)

    def setup(self):
        # the port's decoder first: a port without it fails here, at once
        from neighborhoodwatch_tpu_torch.models import decoder  # noqa: F401
        from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
        run, cfg = self.run, self.cfg
        self.traffic = run.traffic.make(run.mix, run.seed)
        with run.stage("weights"):
            gen = seeds.torch_gen(run.device, run.seed, seeds.WEIGHTS)
            self.state = mistral.make_state(cfg, gen, run.device)
        with run.stage("generator"):
            self.gen = E5EmbeddingGenerator(
                model_name=cfg["model_name"], max_length=self.max_length,
                state=self.state, device=run.device,
                dataset_type="document")
        if not getattr(self.gen.tokenizer, "is_hashed", False):
            raise RuntimeError("the generator loaded a cached HuggingFace "
                               "tokenizer; the reference follows the hash "
                               "tokenizer")
        for ours, theirs in _WIDTHS:
            if getattr(self.gen.config, ours) != cfg[theirs]:
                raise RuntimeError(f"the generator's {ours} is "
                                   f"{getattr(self.gen.config, ours)!r}, "
                                   f"the configuration's {cfg[theirs]!r}")
        self.program = self.gen.generate_embedding
        self.chunk = chunk = self.gen.chunk_size
        # the mix's buckets, the decoder's from LEAST_BUCKET
        buckets = sorted({max(b, LEAST_BUCKET) for b in
                          run.traffic.buckets_in_use(run.mix, chunk,
                                                     self.extra,
                                                     self.max_length)})
        with run.stage(f"graphs {buckets}"):
            self.program(self.traffic.warm_texts(buckets, chunk, self.extra))
        warm, _ = self.traffic.call(0, tag=seeds.WARM)
        with run.stage("warm call"):
            t0 = time.perf_counter()
            self.program(warm)
            call_s = time.perf_counter() - t0
        ahead = math.ceil(run.seconds / max(call_s, 1e-3) * 1.25) + 1
        with run.stage(f"texts of {ahead} calls"):
            self.pool = {c: self.traffic.call(c) for c in range(ahead)}

    def step(self):
        run, c = self.run, self.calls
        texts, words = self.pool.pop(c, (None, None))
        if texts is None:
            with span("nwbench.texts", run.traced):
                texts, words = self.traffic.call(c)
        self.attempted += len(texts)
        with span("nwbench.call", run.traced):
            try:
                out = self.program(texts)
            except Exception as exc:   # a failed call counts, the run goes on
                print(f"encode call {c} failed: {exc!r}")
                self.failed += len(texts)
                out = None
        self.texts.append((texts, words))
        self.outputs.append(out)
        self.calls += 1

    def _served(self):
        return [(w, out) for (_, w), out in zip(self.texts, self.outputs)
                if out is not None]

    def _served_tokens(self):
        served = self._served()
        if not served:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([self.tokens(w) for w, _ in served])

    def _forwards(self):
        """(rows, bucket) of every forward the served calls issued: chunks
        of `chunk` texts, a ragged one padded to whole rows, each at the
        bucket of its longest text."""
        out = []
        for w, _ in self._served():
            t = self.tokens(w)
            for i in range(0, len(t), self.chunk):
                out.append((self.chunk, decoder_yardstick.bucket(
                    int(t[i:i + self.chunk].max()), self.max_length,
                    LEAST_BUCKET)))
        return out

    def end_to_end(self, kinds, window_s):
        """{metric: (value, unit)} for the cell's {metric: kind}; the one
        kind here: "tokens_per_s", the real tokens of every text served
        (BOS and EOS counted) over the window."""
        out = {}
        for name, kind in kinds.items():
            if kind != "tokens_per_s":
                raise KeyError(f"the encode_decoder driver has no kind "
                               f"{kind!r}")
            out[name] = (float(self._served_tokens().sum()) / window_s,
                         "tokens/s")
        return out

    def counters(self):
        return {"tokens": self._served_tokens(), "calls": self.calls,
                "forwards": self._forwards()}

    def free_program(self):
        """Drop the generator (model, graphs, their memory pool; the weights
        stay with the reference); count the rows it served as zero
        vectors, its sign of a failed chunk."""
        self.program = self.gen = None
        for i, out in enumerate(self.outputs):
            if out is not None:
                arr = np.asarray(out, dtype=np.float32)
                self.failed += int((np.abs(arr).sum(1) == 0).sum())
                self.outputs[i] = arr

    def token_ids(self, text: str) -> list:
        """The hash tokenizer's ids of a document: BOS, the words cut to
        max_length - 2, EOS."""
        vocab = self.cfg["vocab_size"]
        ids = hash_tokenizer.token_ids(text, vocab, self.max_length)[1:-1]
        return [self.cfg["bos_token_id"], *ids, self.cfg["eos_token_id"]]

    def check(self, control: bool = False):
        """emb_gap: the largest L2 distance between a served embedding and
        the reference's, over a sample of the served texts drawn from the
        seed, the longest served text and up to RAGGED_PER_CALL rows of each
        call's ragged last chunk (the control's embeddings in place of the
        served ones with control=True)."""
        run = self.run
        n = int(run.cell["check_sample"])
        pool = [(c, j) for c, out in enumerate(self.outputs)
                if out is not None for j in range(len(out))]
        if not pool:
            return {"emb_gap": float("nan")}
        rng = seeds.numpy_rng(run.seed, seeds.SAMPLE, 1 << 30)
        pick = {pool[p] for p in rng.choice(len(pool), min(n, len(pool)),
                                            replace=False)}
        pick.add(max(pool, key=lambda cj: self.texts[cj[0]][1][cj[1]]))
        for c, out in enumerate(self.outputs):
            tail = len(out) % self.chunk if out is not None else 0
            if tail:
                rows = seeds.numpy_rng(run.seed, seeds.SAMPLE, c).choice(
                    tail, min(RAGGED_PER_CALL, tail), replace=False)
                pick.update((c, len(out) - tail + int(j)) for j in rows)
        pick = sorted(pick)
        ids = [self.token_ids(self.texts[c][0][j]) for c, j in pick]
        want = mistral.embed_many(self.state, self.cfg, ids)
        if control:
            got = mistral.embed_many(self.state, self.cfg, ids, fp8=True)
        else:
            got = torch.from_numpy(np.stack(
                [self.outputs[c][j] for c, j in pick])).to(want.device)
        gaps = (got.float() - want).norm(dim=1)
        gap = float(gaps.max())
        return {"emb_gap": gap if math.isfinite(gap) else math.inf}
