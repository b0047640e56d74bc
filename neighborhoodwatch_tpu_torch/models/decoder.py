"""Decoder embedder: a Mistral decoder (grouped-query attention, rotary
positions, RMSNorm, SwiGLU) pooled at its last token, as
intfloat/e5-mistral-7b-instruct serves it
(https://huggingface.co/intfloat/e5-mistral-7b-instruct; arXiv:2401.00368).
The JAX package has no decoder: this module is held to the plain float32
reference of the repository's tests.

Per layer, on the (B, T, hidden) residual h:
  a = rms(h) w1; q, k, v = a Wq, a Wk, a Wv (heads / kv_heads of head_dim,
  one fused q|k|v GEMM); RoPE on q and k (rotate-half, positions 0..T-1,
  theta^(-2i / head_dim)); causal softmax(q k^T / sqrt(head_dim)) v, query
  head j reading K / V head j // (heads / kv_heads); h += o Wo;
  m = rms(h) w2; h += (silu(m Wg) * m Wu) Wd (one fused gate|up GEMM).
Then rms(h) w_f; the embedding is the row of the text's last token (EOS),
L2-normalized. rms(x) = x / sqrt(mean(x^2) + eps).

Matrices and the token embedding live in the config's dtype (bf16) and
multiply in cuBLAS; the norms' statistics and weights, the RoPE angles,
the softmax and the pooling are fp32. The passes run as D1-D3
(ops/encoder_fused.py: add_rmsnorm, rope, swiglu) and attention as K6's
causal grouped-query mode (ops/attention_kernel.py), hand-written kernels
on CUDA tensors and their plain versions on CPU tensors. Padding is on the
right, so causality alone keeps real tokens off the pad slots: no segment
ids are passed. Up to 4,096 tokens (the model card's limit) the published
4,096-token sliding window covers every earlier token, so full causal
attention is exact and no window is built.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from neighborhoodwatch_tpu_torch.ops.attention_kernel import masked_attention
from neighborhoodwatch_tpu_torch.ops.encoder_fused import (
    add_rmsnorm, rope, rope_table, swiglu,
)
from neighborhoodwatch_tpu_torch.utils.profiling import count

INIT_STD = 0.02


@dataclass(frozen=True)
class DecoderConfig:
    """Mistral-7B-v0.1's published widths (e5-mistral-7b-instruct's
    config.json) by default."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 32768
    bos_token_id: int = 1
    eos_token_id: int = 2
    dtype: str = "bfloat16"     # matrices, embedding and activations

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


E5_MISTRAL = "intfloat/e5-mistral-7b-instruct"
DECODER_CONFIGS = {E5_MISTRAL: DecoderConfig()}
# the model card's limit: texts are cut at 4,096 tokens
MAX_LENGTH = 4096

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        h, d, dt = cfg.hidden_size, cfg.head_dim, _DTYPES[cfg.dtype]
        qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * d
        self.input_norm = nn.Parameter(torch.ones(h))
        self.qkv = nn.Linear(h, qkv, bias=False, dtype=dt)
        self.o = nn.Linear(cfg.num_heads * d, h, bias=False, dtype=dt)
        self.post_norm = nn.Parameter(torch.ones(h))
        self.gate_up = nn.Linear(h, 2 * cfg.intermediate_size, bias=False,
                                 dtype=dt)
        self.down = nn.Linear(cfg.intermediate_size, h, bias=False, dtype=dt)

    def forward(self, res, a, cos, sin, next_norm):
        """(residual, the next block's normed input) after this layer, from
        the residual and this layer's normed input `a`."""
        cfg = self.cfg
        b, t, _ = a.shape
        H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qkv = rope(self.qkv(a), H + KV, d, cos, sin)
        q = qkv[..., :H * d].view(b, t, H, d)
        k = qkv[..., H * d:(H + KV) * d].view(b, t, KV, d)
        v = qkv[..., (H + KV) * d:].view(b, t, KV, d)
        ctx = masked_attention(q, k, v, None, 1.0 / math.sqrt(d),
                               causal=True)
        eps = cfg.rms_norm_eps
        res, m = add_rmsnorm(res, self.o(ctx.reshape(b, t, H * d)),
                             self.post_norm, eps)
        mlp = self.down(swiglu(self.gate_up(m)))
        return add_rmsnorm(res, mlp, next_norm, eps)


class DecoderEncoder(nn.Module):
    """Token ids -> the final RMSNorm's output (B, T, hidden) in the
    config's dtype. `positions` rows of the RoPE table are kept."""

    def __init__(self, config: DecoderConfig, positions: int = MAX_LENGTH):
        super().__init__()
        self.config = config
        self.positions = positions
        self.embed = nn.Embedding(config.vocab_size, config.hidden_size,
                                  dtype=_DTYPES[config.dtype])
        self.layers = nn.ModuleList(DecoderLayer(config)
                                    for _ in range(config.num_layers))
        self.norm = nn.Parameter(torch.ones(config.hidden_size))
        self.rope_cos = self.rope_sin = None

    def set_rope(self, device):
        self.rope_cos, self.rope_sin = rope_table(
            self.positions, self.config.head_dim, self.config.rope_theta,
            device)

    def forward(self, input_ids, attention_mask):
        cfg = self.config
        count("decoder.forwards", 1)
        t = input_ids.shape[1]
        if t > self.positions:
            raise ValueError(f"{t} positions past the RoPE table's "
                             f"{self.positions}")
        cos, sin = self.rope_cos[:t], self.rope_sin[:t]
        hidden = F.embedding(input_ids, self.embed.weight)
        res, a = add_rmsnorm(hidden, None, self.layers[0].input_norm,
                             cfg.rms_norm_eps)
        for i, layer in enumerate(self.layers):
            nxt = self.layers[i + 1].input_norm if i + 1 < len(self.layers) \
                else self.norm
            res, a = layer(res, a, cos, sin, nxt)
        return a


def last_token_normalize(hidden, attention_mask):
    """The row of each text's last real token in fp32, L2-normalized (a zero
    norm divides by 1): e5-mistral's pooling on right-padded rows. A row
    of padding alone takes its first position."""
    last = (attention_mask.sum(dim=1) - 1).clamp_min(0).long()
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    pooled = hidden[rows, last].float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.where(norm == 0, torch.ones_like(norm), norm)


def build_decoder(config: DecoderConfig, state, seed: int, device,
                  positions: int = MAX_LENGTH):
    """(model on `device`, eval mode, pretrained flag): the modules made
    without memory (meta), then the state's tensors adopted as they are
    where they already have the parameters' dtype and device (no copy: a
    7B state is held once), else a seeded random init drawn on the device
    (matrices and embedding N(0, 0.02), norms 1)."""
    with torch.device("meta"):
        model = DecoderEncoder(config, positions)
    if state is not None:
        want = dict(model.named_parameters())
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise KeyError(f"decoder state: missing {missing}, unexpected "
                           f"{extra}")
        model.load_state_dict(
            {k: torch.as_tensor(v).to(device, dtype=want[k].dtype)
             for k, v in state.items()}, assign=True)
    else:
        model.to_empty(device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("norm"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, INIT_STD, generator=gen)
    model.set_rope(device)
    return model.eval(), state is not None


def load_hf_weights(model_name: str, config: DecoderConfig):
    """DecoderEncoder state_dict from a locally cached HF MistralModel
    checkpoint, or None when there is none (no network access is tried):
    q, k, v stacked into qkv, gate and up into gate_up, norms in fp32."""
    try:
        from transformers import AutoModel
        from transformers.utils import hub as _hub
        if not _hub.try_to_load_from_cache(model_name, "config.json"):
            raise FileNotFoundError(f"{model_name} not in local HF cache")
        hf = AutoModel.from_pretrained(model_name, local_files_only=True,
                                       torch_dtype=_DTYPES[config.dtype])
    except Exception as e:
        print(f"   [warn] no local checkpoint for {model_name} ({e}); "
              f"falling back to random init")
        return None
    return convert_hf_state_dict(hf.state_dict(), config)


def convert_hf_state_dict(sd: dict, config: DecoderConfig) -> dict:
    """HF MistralModel state_dict -> DecoderEncoder state_dict."""
    out = {"embed.weight": sd["embed_tokens.weight"],
           "norm": sd["norm.weight"].float()}
    for i in range(config.num_layers):
        p = f"layers.{i}."
        a, m = p + "self_attn.", p + "mlp."
        out[p + "input_norm"] = sd[p + "input_layernorm.weight"].float()
        out[p + "post_norm"] = \
            sd[p + "post_attention_layernorm.weight"].float()
        out[p + "qkv.weight"] = torch.cat(
            [sd[a + f"{n}_proj.weight"] for n in "qkv"])
        out[p + "o.weight"] = sd[a + "o_proj.weight"]
        out[p + "gate_up.weight"] = torch.cat(
            [sd[m + "gate_proj.weight"], sd[m + "up_proj.weight"]])
        out[p + "down.weight"] = sd[m + "down_proj.weight"]
    return out
