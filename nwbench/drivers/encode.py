"""Driver of the e5 encoder's entry point,
`E5EmbeddingGenerator(model_name, state=...).generate_embedding(texts)`,
as data/sources.py calls it: each call a batch of texts made from
(seed, call), the embeddings returned on the host; the next call is issued
when the last returns (a closed loop of one client).

The weights are made on the card from the seed (reference/bert.py) and
handed to the generator and to the reference alike. Set-up captures the
graph of every token bucket the mix can reach (traffic/texts.py) and runs
one call of the mix, and makes the texts of the calls the window is
expected to need, so that the window holds only the encoder's calls.
The check embeds a sample of the served texts, drawn from the seed, with
the longest of the window and a few rows of each call's ragged last chunk
(padded to a whole chunk by the generator) among them, by the float32
reference.
"""

import math
import time

import numpy as np
import torch

from nwbench import seeds
from nwbench.reference import bert, hash_tokenizer
from nwbench.trace import span

MAX_LENGTH = 512
RAGGED_PER_CALL = 4
# the port's config fields that must equal the configuration's
_WIDTHS = (("hidden_size", "hidden_size"), ("num_layers", "num_hidden_layers"),
           ("num_heads", "num_attention_heads"),
           ("intermediate_size", "intermediate_size"),
           ("vocab_size", "vocab_size"),
           ("max_position_embeddings", "max_position_embeddings"),
           ("type_vocab_size", "type_vocab_size"),
           ("layer_norm_eps", "layer_norm_eps"), ("dtype", "serving_dtype"))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.attempted = self.failed = 0
        self.calls = 0
        self.texts, self.outputs = [], []
        vocab = self.cfg["vocab_size"]
        # tokens of a text beyond its words: [CLS], [SEP] and the prefix
        self.extra = len(hash_tokenizer.token_ids(self.cfg["prefix"], vocab))

    def tokens(self, words) -> np.ndarray:
        return np.minimum(np.asarray(words) + self.extra, MAX_LENGTH)

    def setup(self):
        from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
        run, cfg = self.run, self.cfg
        self.traffic = run.traffic.make(run.mix, run.seed)
        with run.stage("weights"):
            gen = seeds.torch_gen(run.device, run.seed, seeds.WEIGHTS)
            self.state = bert.make_state(cfg, gen, run.device)
        with run.stage("generator"):
            self.gen = E5EmbeddingGenerator(
                model_name=cfg["model_name"], max_length=MAX_LENGTH,
                state=self.state, device=run.device)
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
        buckets = run.traffic.buckets_in_use(run.mix, chunk, self.extra,
                                             MAX_LENGTH)
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

    def _served_tokens(self):
        return np.concatenate([self.tokens(w) for (_, w), out
                               in zip(self.texts, self.outputs)
                               if out is not None])

    def end_to_end(self, kinds, window_s):
        """{metric: (value, unit)} for the cell's {metric: kind}; the one
        kind here: "tokens_per_s", the real tokens of every text served
        over the window."""
        out = {}
        for name, kind in kinds.items():
            if kind != "tokens_per_s":
                raise KeyError(f"the encode driver has no kind {kind!r}")
            out[name] = (float(self._served_tokens().sum()) / window_s,
                         "tokens/s")
        return out

    def counters(self):
        return {"tokens": self._served_tokens(), "calls": self.calls}

    def free_program(self):
        """Drop the generator (model, graphs, their memory pool); count the
        rows it served as zero vectors, its sign of a failed chunk."""
        self.program = self.gen = None
        for i, out in enumerate(self.outputs):
            if out is not None:
                arr = np.asarray(out, dtype=np.float32)
                self.failed += int((np.abs(arr).sum(1) == 0).sum())
                self.outputs[i] = arr

    def check(self, control: bool = False):
        """emb_gap: the largest L2 distance between a served embedding and
        the reference's, over a sample of the served texts drawn from the
        seed, the longest served text and up to RAGGED_PER_CALL rows of each
        call's ragged last chunk (the control's embeddings in place of the
        served ones with control=True)."""
        run, cfg = self.run, self.cfg
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
        gap = 0.0
        for c, j in sorted(pick):
            text = cfg["prefix"] + self.texts[c][0][j]
            ids = hash_tokenizer.token_ids(text, cfg["vocab_size"],
                                           MAX_LENGTH)
            want = bert.embed(self.state, cfg, ids)
            got = bert.embed(self.state, cfg, ids, fp8=True) if control \
                else torch.from_numpy(self.outputs[c][j]).to(want.device)
            g = float((got.float() - want).norm())
            gap = max(gap, g if math.isfinite(g) else math.inf)
        return {"emb_gap": gap}
