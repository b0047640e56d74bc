"""The decoder embedder's fixed arithmetic (e5-mistral-7b-instruct's
Mistral block): its operations and bytes worked out from the
configuration's widths and the shapes of the texts and forwards alone,
never from the program's counts; the card's peaks are those of
yardstick.py.

Frozen here so that a change to the program cannot move them.
"""

from nwbench.yardstick import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

ACT_BYTES = 2          # bf16 activations
NORM_BYTES = 4         # fp32 RMSNorm weights, RoPE cos / sin


def widths(cfg: dict) -> dict:
    heads = cfg["num_attention_heads"]
    return {"hidden": cfg["hidden_size"], "heads": heads,
            "kv": cfg["num_key_value_heads"],
            "head_dim": cfg["hidden_size"] // heads,
            "inter": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"]}


def linear_flops_per_token(cfg: dict) -> int:
    """The projections and the MLP of one token over every layer: q|k|v
    (hidden x (heads + 2 kv) head_dim), o, gate, up and down; 2 FLOPs a
    multiply-add (13.96 GFLOP at e5-mistral's widths)."""
    w = widths(cfg)
    h, d = w["hidden"], w["head_dim"]
    per_layer = (h * (w["heads"] + 2 * w["kv"]) * d + w["heads"] * d * h
                 + 3 * h * w["inter"])
    return 2 * per_layer * w["layers"]


def causal_attn_flops(cfg: dict, length: int) -> int:
    """The causal products of one text of `length` tokens over every
    layer: query i's scores and P V over its i + 1 keys, 4 head_dim
    FLOPs a key a head, so 2 heads head_dim L (L + 1) a layer."""
    w = widths(cfg)
    return (2 * w["heads"] * w["head_dim"] * length * (length + 1)
            * w["layers"])


def text_flops(cfg: dict, tokens) -> float:
    """Model FLOPs of texts of the given real token counts, each at its
    own length (no padding)."""
    lin = linear_flops_per_token(cfg)
    return float(sum(int(t) * lin + causal_attn_flops(cfg, int(t))
                     for t in tokens))


def bucket(tokens: int, max_length: int, least: int = 64) -> int:
    """The decoder's padded length of a chunk whose longest text has
    `tokens` tokens: the power of two from `least` that holds it, at most
    max_length."""
    b = least
    while b < tokens and b < max_length:
        b *= 2
    return min(b, max_length)


def causal_attn_bound_s(cfg: dict, rows: int, seq: int) -> float:
    """The least time of one forward's causal attention at (rows, seq):
    every row's causal products at the bf16 tensor-core peak."""
    return rows * causal_attn_flops(cfg, seq) / PEAK_BF16_FLOPS


def pass_bytes(cfg: dict, rows: int, seq: int) -> float:
    """Bytes of one forward's RMSNorm, RoPE and SwiGLU passes at (rows,
    seq), each operand read once and written once at the rows x seq
    slots: the first norm reads the embeddings and writes its rows; each
    of the 2 x layers add-and-norms reads the residual and the update and
    writes both; RoPE reads and writes the q and k heads and reads the
    positions' cos / sin; SwiGLU reads gate|up and writes its half; every
    norm reads its fp32 weight."""
    w = widths(cfg)
    h, layers, slots = w["hidden"], w["layers"], rows * seq
    qk = (w["heads"] + w["kv"]) * w["head_dim"]
    act = ACT_BYTES * slots
    norms = act * 2 * h + layers * 2 * act * 4 * h \
        + (2 * layers + 1) * NORM_BYTES * h
    rope = layers * (act * 2 * qk + NORM_BYTES * seq * w["head_dim"])
    swiglu = layers * act * 3 * w["inter"]
    return float(norms + rope + swiglu)


def pass_bound_s(cfg: dict, rows: int, seq: int) -> float:
    return pass_bytes(cfg, rows, seq) / PEAK_HBM_BYTES
