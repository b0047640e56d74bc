"""The decoder embedder's plain reference for the repository's tests (a
copy of nwbench/reference/mistral.py): a Mistral decoder as published
(intfloat/e5-mistral-7b-instruct's config.json and model card,
arXiv:2401.00368, Mistral-7B-v0.1 arXiv:2310.06825) in float32, one text
at a time with no padding and so no mask, then the last token's row
after the final RMSNorm, L2-normalized. Also the seeded weights that the
benchmark hands to both sides.

Per layer: a = rms(h) w1; q, k, v = a Wq, a Wk, a Wv; RoPE on q and k
(rotate-half, positions 0..n-1, theta^(-2i / head_dim)); causal
softmax(q k^T / sqrt(head_dim)) v, query head j reading K / V head
j // (heads / kv_heads); h += o Wo; m = rms(h) w2; h += (silu(m Wg) *
m Wu) Wd. rms(x) = x / sqrt(mean(x^2) + eps).

Departures from the published description, each also the program's:
  - the weights are drawn from the seed (`make_state`), the published ones
    are not fetched; RMSNorm weights 1 + N(0, 0.1), so no norm is the
    identity;
  - the 4,096-token sliding window is not built: up to the card's 4,096
    tokens it covers every earlier token, so attention is fully causal;
  - the weights are held as the program serves them (bf16 matrices and
    embedding, fp32 norms) and widened to float32 here, where the
    published checkpoint stores float16.
The RoPE angles are worked out in float64 and rounded to float32.

`embed_many` computes layer by layer over every text, each layer's weights
widened to float32 in turn, so that a check of a 7B model needs one
layer's float32 copy beside the served weights. `fp8=True` is the
control: every matrix product takes its two operands rounded to float8
e4m3 under a per-tensor scale (amax / 448), as an fp8 inference path
would, and runs otherwise as the reference.
"""

import math

import torch
import torch.nn.functional as F

INIT_STD = 0.02
NORM_STD = 0.1
FP8_MAX = 448.0
_MATS = ("qkv", "o", "gate_up", "down")


def _shapes(cfg: dict) -> dict:
    h = cfg["hidden_size"]
    d = h // cfg["num_attention_heads"]
    heads = cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"]
    inter = cfg["intermediate_size"]
    return {"qkv": (heads * d, h), "o": (h, cfg["num_attention_heads"] * d),
            "gate_up": (2 * inter, h), "down": (h, inter)}


def make_state(cfg: dict, seed_gen: torch.Generator, device) -> dict:
    """Seeded weights with the key names of the port's DecoderEncoder
    state_dict, made on `device`: each layer's matrices in one bfloat16
    draw (the type the port serves them in), the embedding in bfloat16,
    the RMSNorm weights in float32. Matrices and embedding N(0, 0.02),
    norm weights 1 + N(0, 0.1)."""
    h = cfg["hidden_size"]
    layers = cfg["num_hidden_layers"]
    shapes = _shapes(cfg)

    def draw(n, dtype, std):
        return torch.randn(n, generator=seed_gen, device=device,
                           dtype=dtype).mul_(std)
    state = {"embed.weight": draw(cfg["vocab_size"] * h, torch.bfloat16,
                                  INIT_STD).view(cfg["vocab_size"], h)}
    per_layer = sum(a * b for a, b in shapes.values())
    for i in range(layers):
        flat, off = draw(per_layer, torch.bfloat16, INIT_STD), 0
        for name in _MATS:
            a, b = shapes[name]
            state[f"layers.{i}.{name}.weight"] = flat[off:off + a * b].view(
                a, b)
            off += a * b
    norms = draw((2 * layers + 1) * h, torch.float32, NORM_STD).add_(1.0)
    norms = norms.view(2 * layers + 1, h)
    for i in range(layers):
        state[f"layers.{i}.input_norm"] = norms[2 * i]
        state[f"layers.{i}.post_norm"] = norms[2 * i + 1]
    state["norm"] = norms[2 * layers]
    return state


def _fp8(x):
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, fp8: bool):
    return _fp8(a) @ _fp8(b) if fp8 else a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (heads, n, d) rotated, rotate-half convention."""
    n, d = x.shape[1], x.shape[2]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    c = ang.cos().float().to(x.device)
    s = ang.sin().float().to(x.device)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat((x1 * c - x2 * s, x2 * c + x1 * s), dim=-1)


def _layer(x, w: dict, cfg: dict, fp8: bool):
    n = x.shape[0]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // heads
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    a = _rms(x, w["input_norm"], eps)
    qkv = _mm(a, w["qkv"].T, fp8)
    q = qkv[:, :heads * d].view(n, heads, d).transpose(0, 1)
    k = qkv[:, heads * d:(heads + kv) * d].view(n, kv, d).transpose(0, 1)
    v = qkv[:, (heads + kv) * d:].view(n, kv, d).transpose(0, 1)
    q, k = _rope(q, theta), _rope(k, theta)
    group = heads // kv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    scores = _mm(q, k.transpose(1, 2), fp8) / math.sqrt(d)
    future = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    scores = scores.masked_fill(future, float("-inf"))
    ctx = _mm(torch.softmax(scores, dim=-1), v, fp8)
    x = x + _mm(ctx.transpose(0, 1).reshape(n, heads * d), w["o"].T, fp8)
    m = _rms(x, w["post_norm"], eps)
    g, u = _mm(m, w["gate_up"].T, fp8).chunk(2, dim=-1)
    return x + _mm(F.silu(g) * u, w["down"].T, fp8)


@torch.no_grad()
def embed_many(state: dict, cfg: dict, texts: list, fp8: bool = False):
    """(len(texts), hidden) float32 unit embeddings of the texts' token
    ids (each a list), each text alone and unpadded, layer by layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb = state["embed.weight"]
    dev = emb.device
    xs = [emb[torch.as_tensor(ids, device=dev, dtype=torch.long)].float()
          for ids in texts]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        w = {n: state[p + n].float() for n in ("input_norm", "post_norm")}
        w.update({n: state[p + n + ".weight"].float() for n in _MATS})
        xs = [_layer(x, w, cfg, fp8) for x in xs]
        del w
    wf = state["norm"].float()
    out = []
    for x in xs:
        last = _rms(x[-1], wf, cfg["rms_norm_eps"])
        out.append(last / last.norm())
    return torch.stack(out)


def embed(state: dict, cfg: dict, ids: list, fp8: bool = False):
    """(hidden,) float32 unit embedding of one text's token ids."""
    return embed_many(state, cfg, [ids], fp8)[0]
