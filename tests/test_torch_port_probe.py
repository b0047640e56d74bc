"""PyTorch port's encoder probe (probes/encoder_probe.py) against the JAX
package's scripts/encoder_probe.py: the same FLOP accounting for the e5
configs, and a run of every row shape at a tiny width on the CPU (the
plain attention under "flash")."""

import importlib.util
import io
import os

import pytest

from neighborhoodwatch_tpu.models.bert_flax import E5_CONFIGS as J_CONFIGS

from neighborhoodwatch_tpu_torch.models.bert import E5_CONFIGS, BertConfig
from neighborhoodwatch_tpu_torch.probes import encoder_probe as probe

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "encoder_probe.py")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("jax_encoder_probe", _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["intfloat/e5-large-v2",
                                  "intfloat/e5-base-v2",
                                  "intfloat/e5-small-v2"])
def test_flops_per_token_matches_reference(ref, name):
    for seq in (128, 256, 512, 1024):
        assert probe.flops_per_token(E5_CONFIGS[name], seq) == \
            ref.flops_per_token(J_CONFIGS[name], seq)
    assert {n for n, _ in probe.ROWS} <= set(J_CONFIGS)


def test_tiny_run_on_cpu():
    tiny = BertConfig(hidden_size=64, num_layers=2, num_heads=1,
                      intermediate_size=128)
    out = io.StringIO()
    rows = probe.run(rows=(("tiny", 128), ("tiny", 256)), tokens=2048,
                     iters=1, device="cpu", configs={"tiny": tiny}, out=out)
    assert [(r["seq"], r["impl"]) for r in rows] == \
        [(128, "auto"), (128, "flash"), (256, "auto"), (256, "flash")]
    for r in rows:
        assert r["batch"] == max(8, 2048 // r["seq"])
        assert r["s_per_call"] > 0 and r["pct_bf16_peak"] is None
        assert r["launches"] == 0        # the plain version on the CPU
        assert r["tflop_per_s"] == pytest.approx(
            r["mtok_per_s"] * 1e6 * probe.flops_per_token(tiny, r["seq"])
            / 1e12)
    text = out.getvalue()
    assert "seq 1024: skipped" in text and "n/a of the bf16 peak" in text
    assert text.splitlines()[0].startswith("cpu")
