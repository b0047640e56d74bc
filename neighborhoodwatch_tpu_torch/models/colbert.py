"""ColBERT v2 per-token embedding generator (counterpart of
models/colbert_flax.py).

Replaces the reference's colbert-ai CollectionEncoder (reference:
model_generator.py:392-439: encodes passages into per-token 128-d
embeddings, returns the flattened tensor + per-passage token counts) with
the BERT-base backbone of models/bert.py plus the 128-d linear projection
head and per-token L2 normalization. Checkpoint weights load from a local
HF cache when present; otherwise a seeded random init.

`generate_embedding(texts)` returns `([flat_token_embeddings], token_counts)`
— the contract core/colbert_pipeline.process_source_dataset consumes
(reference: colbert_knn.py:51-63).
"""

import numpy as np
import torch
import torch.nn as nn

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.models.bert import (
    BertEncoder, COLBERT_BASE_CONFIG, bert_state_from_flax,
    convert_torch_state_dict, init_params, load_hf_weights,
)
from neighborhoodwatch_tpu_torch.models.generators import EmbeddingGenerator
from neighborhoodwatch_tpu_torch.models.registry import EmbeddingModelName
from neighborhoodwatch_tpu_torch.models.tokenizer import load_tokenizer

COLBERT_DIM = 128
COLBERT_HF_REPO = "colbert-ir/colbertv2.0"
# bert-base-uncased [unused1] — colbert-ai's "[D]" document marker, inserted
# after [CLS] by its DocTokenizer before encoding.
DOC_MARKER_ID = 2


def colbert_state_from_torch(sd: dict, config=COLBERT_BASE_CONFIG) -> dict:
    """Map a ColBERT torch state_dict (BERT backbone under ``bert.`` + the
    128-d ``linear.weight`` projection, no bias — the checkpoint layout of
    colbert-ir/colbertv2.0) onto :class:`ColbertModel`'s state_dict."""
    out = {f"bert.{k}": v for k, v in
           convert_torch_state_dict(sd, config, prefix="bert.").items()}
    head = torch.as_tensor(sd["linear.weight"])
    assert tuple(head.shape) == (COLBERT_DIM, config.hidden_size), head.shape
    out["linear.weight"] = head
    return out


def colbert_state_from_flax(params, config=COLBERT_BASE_CONFIG) -> dict:
    """The JAX package's ColbertModel parameter tree as numpy arrays
    (``{"params": {"bert": ..., "linear": {"kernel"}}}``) ->
    :class:`ColbertModel`'s state_dict: the weights carried across."""
    p = params["params"]
    out = {f"bert.{k}": v
           for k, v in bert_state_from_flax(p["bert"], config).items()}
    out["linear.weight"] = torch.as_tensor(
        np.ascontiguousarray(np.asarray(p["linear"]["kernel"]).T))
    return out


def load_colbert_hf_weights(model_name: str = COLBERT_HF_REPO,
                            config=COLBERT_BASE_CONFIG):
    """Full pretrained ColBERT state_dict (backbone + projection head) from
    a locally cached HF checkpoint; None when unavailable."""
    try:
        from transformers.utils import hub as _hub
        sd = None
        path = _hub.try_to_load_from_cache(model_name, "model.safetensors")
        if isinstance(path, str):
            try:
                from safetensors.torch import load_file
                sd = load_file(path)
            except Exception as e:
                # fall through to the .bin checkpoint
                print(f"   [warn] cached safetensors unreadable ({e}); "
                      f"trying pytorch_model.bin")
        if sd is None:
            path = _hub.try_to_load_from_cache(model_name, "pytorch_model.bin")
            if isinstance(path, str):
                sd = torch.load(path, map_location="cpu", weights_only=True)
        if sd is None:
            raise FileNotFoundError(f"{model_name} not in local HF cache")
        return colbert_state_from_torch(sd, config)
    except Exception as e:
        print(f"   [warn] no local ColBERT checkpoint ({e})")
        return None


class ColbertModel(nn.Module):
    """BERT backbone + linear 128-d per-token head + L2 normalize."""

    def __init__(self, config=COLBERT_BASE_CONFIG):
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config)
        self.linear = nn.Linear(config.hidden_size, COLBERT_DIM, bias=False)

    def forward(self, input_ids, attention_mask):
        proj = self.linear(self.bert(input_ids, attention_mask))
        norm = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
        return proj / torch.where(norm == 0, torch.ones_like(norm), norm)


class ColbertEmbeddingGenerator(EmbeddingGenerator):
    """`state` is a ColbertModel state_dict (e.g. from
    colbert_state_from_flax); None loads the cached checkpoint, else the
    cached bert-base-uncased backbone under a random head, else a seeded
    random init. `device=None` means "cuda" and raises without a card."""

    def __init__(self, model_name=EmbeddingModelName.COLBERT_V2.value,
                 chunk_size: int = 300_000, max_length: int = 220,
                 state=None, seed: int = 0, hf_backbone="bert-base-uncased",
                 config=COLBERT_BASE_CONFIG, device=None):
        super().__init__(model_name, chunk_size=chunk_size,
                         output_dimension=COLBERT_DIM)
        self.device = resolve_device(device)
        self.max_length = max_length
        self.config = config
        # prefer the real ColBERT tokenizer config when cached; the backbone
        # tokenizer is identical (bert-base-uncased vocab) as a fallback
        self.tokenizer = load_tokenizer(COLBERT_HF_REPO, quiet=True)
        if self.tokenizer.is_hashed:
            self.tokenizer = load_tokenizer(hf_backbone)
        self.tokens_seen = 0       # pipeline-level tokens/s accounting
        self.model = ColbertModel(config)
        self.head_pretrained = False
        if state is None:
            init_params(self.model, seed)
            state = load_colbert_hf_weights(config=self.config)
            if state is not None:
                # full checkpoint: backbone + real 128-d projection head
                self.pretrained = self.head_pretrained = True
            else:
                backbone = load_hf_weights(hf_backbone, self.config)
                # a pretrained backbone under a random projection head is
                # NOT ground truth
                state = None if backbone is None else \
                    {f"bert.{k}": v for k, v in backbone.items()}
                self.pretrained = backbone is not None
        else:
            self.pretrained = self.head_pretrained = True
        if state is not None:
            self.model.load_state_dict(state, strict=self.head_pretrained)
        self.model.to(self.device).eval()
        # doc-encoding fidelity with colbert-ai's CollectionEncoder: insert
        # the "[D]" marker after [CLS] and drop punctuation tokens from the
        # output stream. Only meaningful with real vocab + real weights.
        self.use_doc_marker = self.head_pretrained \
            and not self.tokenizer.is_hashed
        self._skiplist = self._punctuation_ids() if self.use_doc_marker \
            else frozenset()

    def _punctuation_ids(self):
        """Token ids colbert-ai's CollectionEncoder masks out of document
        streams (its `skiplist`: every punctuation symbol's token id)."""
        import string
        ids = set()
        for ch in string.punctuation:
            ids.update(self.tokenizer._tok.encode(ch,
                                                  add_special_tokens=False))
        return frozenset(ids)

    def _call_model_api(self, text_list, *args, **kwargs):
        raise NotImplementedError("ColBERT uses generate_embedding directly")

    @torch.no_grad()
    def encode_passages(self, texts, batch_size: int = 64,
                        max_in_flight: int = 16):
        """(total_tokens, 128) embeddings + per-passage token counts — the
        CollectionEncoder.encode_passages contract. Batches are launched
        ahead of the device-to-host reads, so tokenization of batch i+1
        overlaps the encode of batch i (CUDA launches are asynchronous),
        but at most `max_in_flight` device outputs stay live; the window
        drains as ONE device-concatenated copy to the host.

        With real weights + real vocab this matches colbert-ai's document
        encoding: "[D]" marker after [CLS], punctuation tokens dropped."""
        marker = DOC_MARKER_ID if self.use_doc_marker else None
        skip = np.fromiter(self._skiplist, dtype=np.int64) if self._skiplist \
            else None
        all_tokens, counts = [], []

        def drain_group(items):
            if not items:
                return
            flat = torch.cat([d.reshape(-1, COLBERT_DIM)
                              for d, _, _ in items]).cpu().numpy()
            at = 0
            for _, ids, mask in items:
                n = ids.size
                emb = flat[at:at + n].reshape(*ids.shape, COLBERT_DIM)
                at += n
                keep = mask.astype(bool)
                if skip is not None:
                    keep &= ~np.isin(ids, skip)
                for row_emb, row_keep in zip(emb, keep):
                    all_tokens.append(row_emb[row_keep])
                    counts.append(int(row_keep.sum()))
            items.clear()

        pending = []
        for s in range(0, len(texts), batch_size):
            batch = texts[s:s + batch_size]
            ids, mask = self.tokenizer(batch, max_length=self.max_length,
                                       insert_after_cls=marker)
            self.tokens_seen += int(mask.sum())
            dev = self.model(
                torch.from_numpy(ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device))
            pending.append((dev, ids, mask))
            if len(pending) >= max_in_flight:
                drain_group(pending)
        drain_group(pending)
        if not all_tokens:
            return np.empty((0, COLBERT_DIM), dtype=np.float32), []
        return np.concatenate(all_tokens, axis=0), counts

    def generate_embedding(self, text, *args, **kwargs):
        """Returns ([flat_token_embeddings], token_counts)
        (reference: model_generator.py:433-439)."""
        if isinstance(text, str):
            text = [text]
        token_embeddings, token_cnt = self.encode_passages(text)
        return [token_embeddings.flatten()], token_cnt
