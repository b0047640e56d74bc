"""The e5 encoder's plain reference: a BERT encoder as published (post-norm
layers, exact erf GELU, absolute positions, token type 0), then mean
pooling over the text's tokens and L2 normalization, in float32, one
text at a time with no padding and so no mask. Also the seeded weights
that the benchmark hands to both sides.

`embed(..., fp8=True)` is the control: every matrix product takes its two
operands rounded to float8 e4m3 under a per-tensor scale (amax / 448), as
an fp8 inference path would, and runs otherwise as the reference.
"""

import math

import torch
import torch.nn.functional as F

INIT_STD = 0.02
LN_WEIGHT_STD = 0.1
FP8_MAX = 448.0


def _layer_keys(i: int):
    p = f"layers.{i}."
    return p, [p + f"attention.{n}" for n in ("query", "key", "value", "out")]


def make_state(cfg: dict, seed_gen: torch.Generator, device) -> dict:
    """Seeded weights with the key names of the port's BertEncoder
    state_dict, made on `device` in four large draws: the matrices and
    their biases in bfloat16 (the type the port serves them in), the
    embeddings and the layer norms in float32. Matrices, embeddings and
    biases N(0, 0.02); a layer norm's weight 1 + N(0, 0.1), its bias
    N(0, 0.02), so that no bias add or affine is the identity."""
    h = cfg["hidden_size"]
    inter = cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    mats = {}
    for i in range(layers):
        p, attn = _layer_keys(i)
        for name in attn:
            mats[name] = (h, h)
        mats[p + "intermediate"] = (inter, h)
        mats[p + "output"] = (h, inter)
    embs = {"word_embeddings.weight": (cfg["vocab_size"], h),
            "position_embeddings.weight": (cfg["max_position_embeddings"], h),
            "token_type_embeddings.weight": (cfg["type_vocab_size"], h)}
    lns = ["embeddings_ln"] + [f"layers.{i}.{n}" for i in range(layers)
                               for n in ("attention_ln", "output_ln")]

    def draw(n, dtype, std):
        return torch.randn(n, generator=seed_gen, device=device,
                           dtype=dtype).mul_(std)
    flat_mat = draw(sum(a * b for a, b in mats.values()), torch.bfloat16,
                    INIT_STD)
    flat_bias = draw(sum(a for a, _ in mats.values()), torch.bfloat16,
                     INIT_STD)
    flat_emb = draw(sum(a * b for a, b in embs.values()), torch.float32,
                    INIT_STD)
    flat_ln = draw(2 * len(lns) * h, torch.float32, 1.0).view(len(lns), 2, h)
    flat_ln[:, 0].mul_(LN_WEIGHT_STD).add_(1.0)
    flat_ln[:, 1].mul_(INIT_STD)
    state, off, boff = {}, 0, 0
    for name, (a, b) in mats.items():
        state[name + ".weight"] = flat_mat[off:off + a * b].view(a, b)
        state[name + ".bias"] = flat_bias[boff:boff + a]
        off += a * b
        boff += a
    off = 0
    for name, (a, b) in embs.items():
        state[name] = flat_emb[off:off + a * b].view(a, b)
        off += a * b
    for j, name in enumerate(lns):
        state[name + ".weight"], state[name + ".bias"] = flat_ln[j]
    return state


def _fp8(x):
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, fp8: bool):
    return _fp8(a) @ _fp8(b) if fp8 else a @ b


def _linear(x, state, name, fp8):
    w = state[name + ".weight"].float()
    return _mm(x, w.T, fp8) + state[name + ".bias"].float()


def _ln(x, state, name, eps):
    return F.layer_norm(x, x.shape[-1:], state[name + ".weight"].float(),
                        state[name + ".bias"].float(), eps)


@torch.no_grad()
def embed(state: dict, cfg: dict, ids: list, fp8: bool = False):
    """(hidden,) float32 unit embedding of one text's token ids."""
    torch.backends.cuda.matmul.allow_tf32 = False
    eps = cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    dev = state["word_embeddings.weight"].device
    t = torch.as_tensor(ids, device=dev, dtype=torch.long)
    n = t.shape[0]
    x = (state["word_embeddings.weight"][t].float()
         + state["position_embeddings.weight"][:n].float()
         + state["token_type_embeddings.weight"][0].float())
    x = _ln(x, state, "embeddings_ln", eps)
    dh = x.shape[1] // heads
    for i in range(cfg["num_hidden_layers"]):
        p, (qn, kn, vn, on) = _layer_keys(i)
        q, k, v = (_linear(x, state, nm, fp8).view(n, heads, dh)
                   .transpose(0, 1) for nm in (qn, kn, vn))
        scores = _mm(q, k.transpose(1, 2), fp8) / math.sqrt(dh)
        ctx = _mm(torch.softmax(scores, dim=-1), v, fp8)
        attn = _linear(ctx.transpose(0, 1).reshape(n, -1), state, on, fp8)
        x = _ln(x + attn, state, p + "attention_ln", eps)
        mid = F.gelu(_linear(x, state, p + "intermediate", fp8))
        x = _ln(x + _linear(mid, state, p + "output", fp8), state,
                p + "output_ln", eps)
    pooled = x.mean(0)
    return pooled / pooled.norm()
