"""Encoder probe: e5-large-v2 and e5-base-v2 forwards under the
written-out attention ("auto") and the fused one ("flash", which launches
csrc/masked_attention.cu), with seeded random bf16 weights and about
131,072 tokens per forward. Each row prints seconds per call, Mtok/s,
TFLOP/s and the share of the H100's dense bf16 peak, beside the card's
name and power limit.

    python -m neighborhoodwatch_tpu_torch.probes.encoder_probe

Rows: e5-large-v2 at sequence 256 and 512, e5-base-v2 at 512. Sequence
1024 is skipped: the encoder's position table holds 512 rows and its
lookup raises past them.
"""

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from neighborhoodwatch_tpu_torch import resolve_device
from neighborhoodwatch_tpu_torch.models.bert import (
    E5_CONFIGS, BertEncoder, init_params,
)
from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak

# published dense bf16 tensor-core rate of one H100 SXM at 700 W
PEAK_BF16_FLOPS = 989e12
ROWS = (("intfloat/e5-large-v2", 256), ("intfloat/e5-large-v2", 512),
        ("intfloat/e5-base-v2", 512))
SKIPPED_SEQ = 1024
IMPLS = ("auto", "flash")


def flops_per_token(cfg, seq: int) -> int:
    """Forward FLOPs per token: per layer the QKVO projections (4 h^2
    MACs), the MLP (2 h * intermediate) and the attention scores and
    probabilities (2 seq h); 2 FLOPs a MAC."""
    per_layer = (4 * cfg.hidden_size ** 2
                 + 2 * cfg.hidden_size * cfg.intermediate_size
                 + 2 * seq * cfg.hidden_size)
    return 2 * per_layer * cfg.num_layers


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _models(cfg, dev: torch.device, seed: int = 0) -> dict:
    """{impl: BertEncoder} on one seeded state."""
    auto = BertEncoder(dataclasses.replace(cfg, attention_impl="auto"))
    init_params(auto, seed)
    flash = BertEncoder(dataclasses.replace(cfg, attention_impl="flash"))
    flash.load_state_dict(auto.state_dict())
    return {"auto": auto.to(dev).eval(), "flash": flash.to(dev).eval()}


@torch.no_grad()
def bench(model: BertEncoder, seq: int, tokens: int, iters: int,
          dev: torch.device) -> dict:
    """One row: a warm-up forward, then `iters` forwards timed by the host
    clock up to a synchronize. `launches` counts the attention kernel's
    launches over all of them."""
    cfg = model.config
    batch = max(8, tokens // seq)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1000, 20000, (batch, seq)),
                          device=dev)
    mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    before = ak.masked_attention.launches
    model(ids, mask)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = model(ids, mask)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    assert out.shape == (batch, seq, cfg.hidden_size)
    assert bool(torch.isfinite(out).all())
    tok_s = batch * seq / dt
    flops = tok_s * flops_per_token(cfg, seq)
    return {"impl": cfg.attention_impl, "seq": seq, "batch": batch,
            "s_per_call": dt, "mtok_per_s": tok_s / 1e6,
            "tflop_per_s": flops / 1e12,
            "pct_bf16_peak": 100.0 * flops / PEAK_BF16_FLOPS
            if dev.type == "cuda" else None,
            "launches": ak.masked_attention.launches - before}


def run(rows=ROWS, tokens: int = 131_072, iters: int = 3, device=None,
        configs=None, out=sys.stdout) -> list[dict]:
    """Every row of `rows` ((model, seq) pairs) under each impl; `configs`
    maps model names to BertConfigs (default: the e5 configs). Returns the
    rows' dicts."""
    dev = resolve_device(device)
    configs = configs or E5_CONFIGS
    where = card_line() if dev.type == "cuda" else \
        "cpu (a host run: no device figure)"
    print(where, file=out, flush=True)
    print(f"seq {SKIPPED_SEQ}: skipped (the position table holds "
          f"{configs[rows[0][0]].max_position_embeddings} rows and the "
          f"lookup raises past them)", file=out, flush=True)
    results = []
    for name in dict.fromkeys(n for n, _ in rows):
        models = _models(configs[name], dev)
        for seq in (s for n, s in rows if n == name):
            for impl in IMPLS:
                r = {"model": name, **bench(models[impl], seq, tokens,
                                            iters, dev)}
                results.append(r)
                pct = "n/a" if r["pct_bf16_peak"] is None \
                    else f"{r['pct_bf16_peak']:.1f}%"
                print(f"{name} {impl} seq={seq} batch={r['batch']}: "
                      f"{r['s_per_call']:.4f} s/call, "
                      f"{r['mtok_per_s']:.3f} Mtok/s, "
                      f"{r['tflop_per_s']:.1f} TFLOP/s ({pct} of the bf16 "
                      f"peak), attention kernel launches {r['launches']} "
                      f"[{where}]", file=out, flush=True)
        del models
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tokens", type=int, default=131_072,
                   help="tokens per forward")
    p.add_argument("--iters", type=int, default=3,
                   help="timed forwards per row")
    p.add_argument("--device", default=None,
                   help="default cuda; raises without a card")
    args = p.parse_args(argv)
    run(tokens=args.tokens, iters=args.iters, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
