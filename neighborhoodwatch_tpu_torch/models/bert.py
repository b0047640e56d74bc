"""BERT-family encoder (counterpart of models/bert_flax.py).

e5 models are plain BERT encoders + mean pooling, ColBERT is BERT + a
128-d per-token linear head; both run on this one module. Matmul weights
live in the config's activation dtype (bf16 by default: the same values
the JAX module computes with, which casts its fp32 params per call),
layernorm, embeddings and the softmax run in fp32. Attention is written
out (matmul, masked softmax in fp32, matmul) unless the config opts into
the fused attention (`attention_impl="flash"`, JAX's library Pallas kernel
on the TPU): where ops/attention_kernel.py:use_flash admits the shape, it
runs the hand-written Hopper kernel csrc/masked_attention.cu on CUDA tensors
and its plain version on CPU tensors.

One difference from the reference under "flash": on CUDA tensors the gate
also asks for a head dim the kernel instantiates (64 or 128), so a config
the reference's gate admits with head dim 192 or 256 takes the written-out
attention on the card (and the plain version on the CPU, as the reference
takes its library kernel). There a padding query attends to the valid keys
instead of the padding keys; valid rows, the only ones pooling and the
ColBERT head read, get the same attention either way.

Weights load from a locally cached HuggingFace torch checkpoint when
available; otherwise a seeded random init (pipeline testing, not real
ground truth).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from neighborhoodwatch_tpu_torch.ops.attention_kernel import (
    masked_attention, use_flash,
)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"  # activation/matmul dtype
    # "auto" / "xla": the written-out attention below. "flash": the fused
    # masked attention (ops/attention_kernel.py) where its gate admits the
    # shape (sequence % 128, head dim % 64; on CUDA head dim 64 or 128),
    # the written-out one elsewhere.
    attention_impl: str = "auto"
    # GELU flavor: "auto" resolves to the tanh approximation under bf16
    # activations (its error sits below the activation dtype's) and to
    # exact erf-GELU under fp32 (bit-faithful to torch's BERT).
    gelu: str = "auto"  # "auto" | "exact" | "tanh"


E5_CONFIGS = {
    "intfloat/e5-small-v2": BertConfig(hidden_size=384, num_layers=12,
                                       num_heads=12, intermediate_size=1536),
    "intfloat/e5-base-v2": BertConfig(hidden_size=768, num_layers=12,
                                      num_heads=12, intermediate_size=3072),
    "intfloat/e5-large-v2": BertConfig(hidden_size=1024, num_layers=24,
                                       num_heads=16, intermediate_size=4096),
}

COLBERT_BASE_CONFIG = BertConfig()  # bert-base-uncased backbone

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(cfg: BertConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _gelu_approximate(cfg: BertConfig) -> bool:
    """Resolve the config's GELU flavor (see BertConfig.gelu)."""
    if cfg.gelu == "auto":
        return _dtype(cfg) == torch.bfloat16
    return cfg.gelu == "tanh"


def _check_attention_impl(cfg: BertConfig) -> None:
    if cfg.attention_impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        _check_attention_impl(config)
        self.config = config
        h, dt = config.hidden_size, _dtype(config)
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.query = nn.Linear(h, h, dtype=dt)
        self.key = nn.Linear(h, h, dtype=dt)
        self.value = nn.Linear(h, h, dtype=dt)
        self.out = nn.Linear(h, h, dtype=dt)

    def forward(self, hidden, mask):
        b, t, _ = hidden.shape
        # (B, T, H, D) views of the projections
        q, k, v = (lin(hidden).view(b, t, self.num_heads, self.head_dim)
                   for lin in (self.query, self.key, self.value))
        if use_flash(self.config, t, hidden.device):
            # read in place; padding tokens are segment 0, valid tokens 1
            ctx = masked_attention(q, k, v, mask,
                                   1.0 / math.sqrt(self.head_dim))
            return self.out(ctx.reshape(b, t, -1))
        return self.out(written_out_attention(q, k, v, mask))


def written_out_attention(q, k, v, mask):
    """(B, T, H, D) q, k, v and a (B, T) bool key mask -> (B, T, H*D) context
    of the written-out attention: (B, H, T, T) logits, scaled and masked in
    fp32, stored in the activation dtype (bf16 keeps fp32's exponent range,
    so the -1e9 mask survives) and widened again for a stable softmax."""
    b, t, _, d = q.shape
    dt = q.dtype
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))    # (B, H, T, D)
    logits = (q @ k.transpose(2, 3)).float() / math.sqrt(d)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full((), -1e9, device=logits.device))
    probs = torch.softmax(logits.to(dt).float(), dim=-1).to(dt)
    return (probs @ v).transpose(1, 2).reshape(b, t, -1)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        h, dt = config.hidden_size, _dtype(config)
        eps = config.layer_norm_eps
        self.attention = BertSelfAttention(config)
        self.attention_ln = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Linear(h, config.intermediate_size, dtype=dt)
        self.output = nn.Linear(config.intermediate_size, h, dtype=dt)
        self.output_ln = nn.LayerNorm(h, eps=eps)
        self._gelu = "tanh" if _gelu_approximate(config) else "none"

    def forward(self, hidden, mask):
        dt = hidden.dtype
        attn = self.attention(hidden, mask)
        hidden = self.attention_ln((hidden + attn).float()).to(dt)
        mlp = F.gelu(self.intermediate(hidden), approximate=self._gelu)
        mlp = self.output(mlp)
        return self.output_ln((hidden + mlp).float()).to(dt)


class BertEncoder(nn.Module):
    """Token ids -> last hidden states (B, T, H) in fp32."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.embeddings_ln = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(config)
                                    for _ in range(config.num_layers))

    def forward(self, input_ids, attention_mask):
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(pos_ids)[None]
               + self.token_type_embeddings(torch.zeros_like(input_ids)))
        hidden = self.embeddings_ln(emb).to(_dtype(self.config))
        mask = attention_mask.bool()
        for layer in self.layers:
            hidden = layer(hidden, mask)
        return hidden.float()


def mean_pool_normalize(hidden, attention_mask):
    """Masked mean pooling + L2 normalization in fp32: the e5 embedding
    head (SentenceTransformer's `normalize_embeddings=True` encode,
    reference: model_generator.py:285-287). The token count is clamped at
    1 and a zero norm divides by 1."""
    hidden = hidden.float()
    mask = attention_mask[..., None].to(hidden.dtype)
    summed = (hidden * mask).sum(dim=1)
    counts = mask.sum(dim=1).clamp_min(1.0)
    pooled = summed / counts
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.where(norm == 0, torch.ones_like(norm), norm)


def init_params(module: nn.Module, seed: int = 0) -> None:
    """Seeded random init in place, from an explicit CPU torch.Generator
    (the same weights on every device): matmul and embedding weights
    N(0, 0.02), biases 0, layernorms (1, 0). The JAX package draws other
    numbers from the same seed; carry weights across with
    models.colbert.colbert_state_from_flax to compare the two."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("_ln.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                w = torch.empty(p.shape, dtype=torch.float32)
                w.normal_(0.0, 0.02, generator=gen)
                p.copy_(w)


# --------------------------------------------------------------------------
# HuggingFace torch checkpoint -> this module's state_dict (local cache only)
# --------------------------------------------------------------------------

def load_hf_weights(model_name: str, config: BertConfig):
    """BertEncoder state_dict from a locally cached HF torch BERT
    checkpoint, or None when there is none (no network access is tried)."""
    try:
        from transformers import AutoModel
        from transformers.utils import hub as _hub
        if not _hub.try_to_load_from_cache(model_name, "config.json"):
            raise FileNotFoundError(f"{model_name} not in local HF cache")
        hf = AutoModel.from_pretrained(model_name, local_files_only=True)
    except Exception as e:
        print(f"   [warn] no local checkpoint for {model_name} ({e}); "
              f"falling back to random init")
        return None
    return convert_torch_state_dict(hf.state_dict(), config)


def convert_torch_state_dict(sd: dict, config: BertConfig, prefix: str = ""):
    """HF torch-BERT state_dict -> BertEncoder state_dict (a renaming: both
    are torch layouts). `sd` maps HF BERT key names
    (``embeddings.word_embeddings.weight``,
    ``encoder.layer.{i}.attention.self.query.weight``, ...) to tensors or
    numpy arrays. `prefix` strips a leading scope (ColBERT checkpoints nest
    the backbone under ``bert.``)."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    out = {}

    def put(dst, src):
        for part in ("weight", "bias"):
            out[f"{dst}.{part}"] = torch.as_tensor(sd[f"{src}.{part}"])

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{name}.weight"] = torch.as_tensor(
            sd[f"embeddings.{name}.weight"])
    put("embeddings_ln", "embeddings.LayerNorm")
    for i in range(config.num_layers):
        b, d = f"encoder.layer.{i}", f"layers.{i}"
        for name in ("query", "key", "value"):
            put(f"{d}.attention.{name}", f"{b}.attention.self.{name}")
        put(f"{d}.attention.out", f"{b}.attention.output.dense")
        put(f"{d}.attention_ln", f"{b}.attention.output.LayerNorm")
        put(f"{d}.intermediate", f"{b}.intermediate.dense")
        put(f"{d}.output", f"{b}.output.dense")
        put(f"{d}.output_ln", f"{b}.output.LayerNorm")
    return out


def bert_state_from_flax(params, config: BertConfig) -> dict:
    """The JAX package's BertEncoder parameter tree (numpy arrays, the
    layout its `convert_torch_state_dict` produces) -> BertEncoder
    state_dict. Flax Dense kernels are (in, out) and its attention
    projections (hidden, heads, head_dim) / (heads, head_dim, hidden)."""
    import numpy as np
    h = config.hidden_size
    out = {}

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))

    def ln(dst, p):
        out[f"{dst}.weight"] = t(p["scale"])
        out[f"{dst}.bias"] = t(p["bias"])

    def lin(dst, p, in_dim):
        out[f"{dst}.weight"] = t(np.asarray(p["kernel"]).reshape(in_dim, -1).T)
        out[f"{dst}.bias"] = t(np.asarray(p["bias"]).reshape(-1))

    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{name}.weight"] = t(params[name]["embedding"])
    ln("embeddings_ln", params["embeddings_ln"])
    for i in range(config.num_layers):
        p, d = params[f"layer_{i}"], f"layers.{i}"
        for name in ("query", "key", "value", "out"):
            lin(f"{d}.attention.{name}", p["attention"][name], h)
        ln(f"{d}.attention_ln", p["attention_ln"])
        lin(f"{d}.intermediate", p["intermediate"], h)
        lin(f"{d}.output", p["output"], config.intermediate_size)
        ln(f"{d}.output_ln", p["output_ln"])
    return out
