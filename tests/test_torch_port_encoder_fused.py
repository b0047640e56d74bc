"""The encoders' fused passes (ops/encoder_fused.py: E1 embed_layernorm, E2
add_layernorm, E3 masked_softmax) on the CPU, where each wrapper runs its
plain version: against the JAX package's BERT modules on weights carried
across (models/bert.py:bert_state_from_flax), and the wrappers' routing
and refusals.

The kernels run only on the card (tests/test_torch_port_cuda_encoder_fused
.py holds each against its plain version there). Here: E1's plain path as
`bert_flax.BertEncoder` with no layers (embeddings and their LayerNorm
alone), E2 and E3's as one `bert_flax.BertLayer` under
attention_impl="auto", and the two-layer encoder with mean pooling; edge
cases: an all-padding row, T = 1, a hidden width not divisible by 8, the
-1e9 mask under bf16. The wrappers: CPU tensors never load a library; meta
tensors stand for CUDA tensors (the device types that take the kernels
widened to "meta", the launch function a fake library), so the refusals
of a wrong dtype, device or width, a refused launch and a failed build
show without a card.

Tolerances: fp32 within 1e-5 abs (the same weights, sums in another
order); under bf16 activations hidden states within 2^-6 of each row's
largest magnitude (bf16 keeps 8 mantissa bits, and the two frameworks
round at other places: XLA fuses, torch rounds each op's output) and the
unit-norm pooled embeddings within 2e-2 abs; the softmax chains of the
two packages within one ulp of the activation dtype."""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu.models import bert_flax

from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
from neighborhoodwatch_tpu_torch.utils import cuda_build

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (hidden, heads): head dim 16; a width not divisible by 8 (head dim 12)
WIDTHS = [(64, 4), (36, 3)]
REAL_LAUNCHER = ef._launcher


def _configs(dtype, hidden, heads, layers):
    kw = dict(hidden_size=hidden, num_heads=heads, num_layers=layers,
              intermediate_size=2 * hidden, dtype=dtype)
    return bert_flax.BertConfig(**kw), tbert.BertConfig(**kw)


def _carried(dtype, hidden, heads, layers, seed):
    """JAX BertEncoder params (biases and LayerNorms perturbed, so a
    mis-mapped one shows) and the port's encoder on the same weights."""
    jcfg, tcfg = _configs(dtype, hidden, heads, layers)
    params = bert_flax.init_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
        .astype(np.float32), params)
    enc = tbert.BertEncoder(tcfg)
    enc.load_state_dict(tbert.bert_state_from_flax(params["params"], tcfg))
    return jcfg, params, enc.eval()


def _ids(seed, lengths, T):
    """(B, T) ids and mask: row i holds lengths[i] valid tokens (0: an
    all-padding row, as pad_rows adds to a ragged tail chunk)."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    ids = rng.integers(999, 30522, mask.shape).astype(np.int32) * mask
    return ids, mask


def _rows_agree(got, want, dtype):
    """fp32: within 1e-5 abs; bf16: within 2^-6 of each row's largest
    magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        scale = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) <= 2.0 ** -6 * scale).all(), \
            float((np.abs(got - want) / scale).max())


CASES = [((5, 32, 0, 17), 32), ((1, 0), 1)]   # ragged + all-padding; T = 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_embeddings_match_flax(dtype, hidden, heads):
    """E1's plain path: the encoder with no layers is the embeddings, their
    LayerNorm and the cast, against bert_flax.BertEncoder(num_layers=0)."""
    jcfg, params, enc = _carried(dtype, hidden, heads, 0, seed=hidden)
    for lengths, T in CASES:
        ids, mask = _ids(T, lengths, T)
        want = bert_flax.BertEncoder(jcfg).apply(
            params, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        assert got.dtype == torch.float32
        _rows_agree(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hidden,heads", WIDTHS)
def test_layer_matches_flax(dtype, hidden, heads):
    """E2 and E3's plain paths: one BertLayer (the written-out attention,
    its two residual LayerNorms) on carried weights against
    bert_flax.BertLayer, every row, the all-padding one included."""
    jcfg, params, enc = _carried(dtype, hidden, heads, 1, seed=hidden + 1)
    jdt, tdt = DTYPES[dtype]
    layer = bert_flax.BertLayer(jcfg)
    for lengths, T in CASES:
        _, mask = _ids(T, lengths, T)
        x = np.random.default_rng(T).standard_normal(
            (len(lengths), T, hidden)).astype(np.float32)
        want = layer.apply({"params": params["params"]["layer_0"]},
                           jnp.asarray(x, jdt), jnp.asarray(mask, bool))
        with torch.no_grad():
            got = enc.layers[0](torch.from_numpy(x).to(tdt),
                                torch.from_numpy(mask).bool())
        assert got.dtype == tdt
        _rows_agree(got.float().numpy(), np.asarray(want, np.float32),
                    dtype)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_two_layer_encoder_and_pooling_match_flax(dtype, atol):
    """The whole forward on the wrappers' plain versions: two layers and
    mean_pool_normalize against the JAX package's."""
    jcfg, params, enc = _carried(dtype, 64, 4, 2, seed=7)
    ids, mask = _ids(3, (32, 9, 0, 1), 32)
    jh = bert_flax.BertEncoder(jcfg).apply(params, jnp.asarray(ids),
                                           jnp.asarray(mask))
    want = np.asarray(bert_flax.mean_pool_normalize(jh, jnp.asarray(mask)))
    with torch.no_grad():
        th = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = tbert.mean_pool_normalize(th, torch.from_numpy(mask)).numpy()
    _rows_agree(th.numpy(), jh, dtype)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[[0, 1, 3]], axis=1), 1.0,
                               atol=1e-5)
    assert not got[2].any()                  # the all-padding row pools 0


def _jax_softmax_chain(logits, mask, head_dim, jdt):
    """bert_flax.py:118-130 on given logits: scale, -1e9 mask, the round
    to bf16 (under bf16 only), fp32 softmax, the activation dtype."""
    x = jnp.asarray(logits, jnp.float32) / np.sqrt(head_dim)
    x = jnp.where(jnp.asarray(mask)[:, None, None, :], x, -1e9)
    if jdt == jnp.bfloat16:
        x = x.astype(jdt)
    return np.asarray(jax.nn.softmax(x.astype(jnp.float32), axis=-1)
                      .astype(jdt).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_mask_survives_and_padding_rows_are_uniform(dtype):
    """E3's plain version: masked keys get probability 0 (under bf16 the
    -1e9 mask survives the round: bf16 keeps fp32's exponent range, and
    fp16 is never rounded to, as in the reference), an all-masked row is
    the uniform row with no NaN, and the chain equals the reference's
    within one ulp; head dim 32, whose sqrt(d) a reciprocal multiply
    rounds otherwise."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    B, H, T, d = 3, 2, 24, 32
    rng = np.random.default_rng(5)
    logits = (8 * rng.standard_normal((B, H, T, T))).astype(np.float32)
    logits = torch.from_numpy(logits).to(tdt)
    mask = np.arange(T)[None, :] < np.array([[T], [7], [0]])
    got = ef.masked_softmax(logits, torch.from_numpy(mask), d)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    assert float(torch.tensor(ef.MASKED).to(torch.bfloat16)) < -9e8
    assert not got[1][..., 7:].any()
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  torch.tensor(1.0 / T).to(tdt).item())
    want = _jax_softmax_chain(logits.float().numpy(), mask, d, jdt)
    ef.outputs_agree(got, torch.from_numpy(want.copy()).to(tdt))


def _kernel_division(x, s, r):
    """csrc/masked_softmax.cu:div_by on fp32 arrays, exactly: q = RN(x r),
    e = RN(x - q s) by an fma, RN(q + e r) by an fma where e is finite and
    not 0. Each product of two fp32 values is exact in float64, and so is
    x - q s; the last sum rounds twice (float64, then fp32), which gives
    the fma's one rounding unless the float64 sum sits on an fp32
    midpoint: returns (quotients, count of such sums)."""
    q = (x.astype(np.float64) * np.float64(r)).astype(np.float32)
    e = (x.astype(np.float64) - q.astype(np.float64) * np.float64(s)).astype(
        np.float32)
    total = q.astype(np.float64) + e.astype(np.float64) * np.float64(r)
    out = total.astype(np.float32)
    mids = 0
    for step in (-np.inf, np.inf):
        near = np.nextafter(out, np.float32(step)).astype(np.float64)
        mids += int((total == (out.astype(np.float64) + near) / 2).sum())
    keep = (e == 0) | ~np.isfinite(e)
    return np.where(keep, q, out), mids


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
def test_the_kernels_scale_is_a_true_division(kind):
    """E3 divides the logits by sqrt(d) as a reciprocal product corrected
    by its fma residual, not by __fdiv_rn (whose slow-path call made ptxas
    spill): for every finite bf16 or fp16 logit of magnitude >= 2^-100 and
    every head dim 1 .. 512 it equals the true division bit for bit (fp32
    division of fp32 operands, computed in float64: its double rounding is
    innocuous), which the round to bf16 after it needs."""
    bits = np.arange(65536, dtype=np.uint32)
    x = ((bits << 16).view(np.float32) if kind == "bfloat16"
         else bits.astype(np.uint16).view(np.float16).astype(np.float32))
    x = x[np.isfinite(x) & (np.abs(x) >= 2.0 ** -100)]
    for d in range(1, 513):
        s = np.float32(math.sqrt(d))
        r = np.float32(1.0) / s
        got, mids = _kernel_division(x, s, r)
        want = (x.astype(np.float64) / np.float64(s)).astype(np.float32)
        assert mids == 0
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(d))


# ---------------------------------------------------- the wrappers


def _calls(device="cpu", dtype=torch.bfloat16, hidden=64, seq=16,
           vocab=50, heads=4):
    """One call of each wrapper on `device`: {name: thunk}."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dt)
    ids = torch.randint(0, vocab, (2, seq), generator=g).to(device)
    w, b = r(hidden), r(hidden)
    mask = (torch.arange(seq)[None, :] < torch.tensor([[seq], [3]])).to(
        device)
    return {
        "embed_layernorm": lambda: ef.embed_layernorm(
            ids, r(vocab, hidden), r(seq, hidden), r(2, hidden), w, b, 1e-12,
            dtype),
        "add_layernorm": lambda: ef.add_layernorm(
            r(2, seq, hidden, dt=dtype), r(2, seq, hidden, dt=dtype), w, b,
            1e-12),
        "masked_softmax": lambda: ef.masked_softmax(
            r(2, heads, seq, seq, dt=dtype), mask, hidden // heads)}


WRAPPERS = ("embed_layernorm", "add_layernorm", "masked_softmax")


def test_cpu_tensors_never_load_a_library(monkeypatch):
    """CPU tensors take the plain versions, uncounted, and build nothing,
    under either variant; so does a whole encoder forward."""
    def no_build(name):
        raise AssertionError(f"loaded {name} for CPU tensors")
    monkeypatch.setattr(cuda_build, "load", no_build)
    ef.reset_launches()
    for variant in ef.VARIANTS:
        with ef.forced_variant(variant):
            for call in _calls().values():
                assert call().device.type == "cpu"
    _, _, enc = _carried("bfloat16", 64, 4, 1, seed=1)
    ids, mask = _ids(1, (16, 3), 16)
    with torch.no_grad():
        enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for name in WRAPPERS:
        w = getattr(ef, name)
        assert w.launches == 0
        assert w.launches_by_variant == {"kernel": 0, "plain": 0}


def test_forced_variant_checks_and_restores():
    with pytest.raises(ValueError):
        with ef.forced_variant("eager"):
            pass
    assert ef._forced_variant is None
    with ef.forced_variant("plain"):
        with ef.forced_variant("kernel"):
            assert ef._forced_variant == "kernel"
        assert ef._forced_variant == "plain"
    assert ef._forced_variant is None


class _FakeLibrary:
    """Stands for a built library: its launch returns `err`."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def launcher(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return self.err
        return launch


@pytest.fixture()
def card(monkeypatch):
    """Meta tensors take the kernels' path, on a fake library; the plain
    versions raise if called. Returns the library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ef, "_ON_CARD", ("cuda", "meta"))
    monkeypatch.setattr(ef, "_launcher", lib.launcher)
    monkeypatch.setattr(ef, "_stream", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    for name in WRAPPERS:
        def plain(*a, name=name, **kw):
            raise AssertionError(f"{name} ran its plain version on the card")
        monkeypatch.setattr(ef, f"{name}_plain", plain)
    ef.reset_launches()
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("name", WRAPPERS)
def test_card_tensors_launch_and_count(card, name, dtype):
    """A card tensor launches the kernel once, on the current stream, with
    the shapes, dtype code and scale the C interface takes; counted."""
    out = _calls("meta", dtype)[name]()
    assert out.device.type == "meta" and out.dtype == dtype
    assert [c[0] for c in card.calls] == [name]
    args = card.calls[0][1]
    assert len(args) == len(ef._ARGTYPES[name]) and args[-1] == 7
    code = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}[dtype]
    if name == "masked_softmax":
        assert args[3:-1] == (2, 4, 16, code, math.sqrt(16))
    elif name == "add_layernorm":
        assert args[5:8] == (2 * 16, 64, code)
    else:
        assert args[7:12] == (2, 16, 64, 50, code)
    w = getattr(ef, name)
    assert w.launches == 1 and w.launches_by_variant == {"kernel": 1,
                                                         "plain": 0}


@pytest.mark.parametrize("name", WRAPPERS)
def test_card_tensors_refuse_a_wrong_dtype(card, name):
    with pytest.raises(TypeError):
        _calls("meta", torch.float64)[name]()
    if name == "embed_layernorm":
        ids = torch.zeros((2, 4), dtype=torch.int32, device="meta")
        t = torch.zeros((9, 8), device="meta")
        with pytest.raises(TypeError):
            ef.embed_layernorm(ids, t, t, t, t[0], t[0], 1e-12,
                               torch.bfloat16)
        with pytest.raises(TypeError):       # a table in bf16
            ef.embed_layernorm(ids.long(), t.bfloat16(), t, t, t[0], t[0],
                               1e-12, torch.bfloat16)
    elif name == "masked_softmax":
        lg = torch.zeros((1, 1, 4, 4), dtype=torch.bfloat16, device="meta")
        with pytest.raises(TypeError):       # an int mask
            ef.masked_softmax(lg, torch.ones((1, 4), dtype=torch.int32,
                                             device="meta"), 16)
    else:
        h = torch.zeros((3, 8), dtype=torch.bfloat16, device="meta")
        with pytest.raises(TypeError):       # bf16 LayerNorm weights
            ef.add_layernorm(h, h, h[0], h[0], 1e-12)
    assert card.calls == [] and getattr(ef, name).launches == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_card_tensors_refuse_a_width_the_kernel_does_not_take(card, name):
    if name == "masked_softmax":
        too_wide = _calls("meta", seq=ef.MAX_SEQ + 1, hidden=64)
    else:
        too_wide = _calls("meta", hidden=ef.MAX_WIDTH + 4, heads=4)
    with pytest.raises(ValueError):
        too_wide[name]()
    if name == "embed_layernorm":
        ids = torch.zeros((2, 9), dtype=torch.long, device="meta")
        t = torch.zeros((8, 16), device="meta")
        with pytest.raises(ValueError):      # more positions than the table
            ef.embed_layernorm(ids, t, t, t, t[0], t[0], 1e-12,
                               torch.bfloat16)
    assert card.calls == [] and getattr(ef, name).launches == 0
    # the widest rows each kernel takes are launched
    widest = (_calls("meta", seq=ef.MAX_SEQ, hidden=64)
              if name == "masked_softmax" else
              _calls("meta", hidden=ef.MAX_WIDTH))
    widest[name]()
    assert len(card.calls) == 1


@pytest.mark.parametrize("name", WRAPPERS)
def test_card_tensors_refuse_another_device(card, monkeypatch, name):
    """Operands on two devices are refused; a device type that takes no
    kernel is refused, never run plain."""
    meta = _calls("meta")
    cpu_w = torch.zeros(64)
    with pytest.raises(ValueError):
        if name == "embed_layernorm":
            ids = torch.zeros((2, 16), dtype=torch.long, device="meta")
            t = torch.zeros((50, 64), device="meta")
            ef.embed_layernorm(ids, t, t, t, cpu_w, cpu_w, 1e-12,
                               torch.bfloat16)
        elif name == "add_layernorm":
            h = torch.zeros((2, 64), dtype=torch.bfloat16, device="meta")
            ef.add_layernorm(h, h, cpu_w, cpu_w, 1e-12)
        else:
            lg = torch.zeros((2, 1, 4, 4), dtype=torch.bfloat16,
                             device="meta")
            ef.masked_softmax(lg, torch.ones((2, 4), dtype=torch.bool), 16)
    monkeypatch.setattr(ef, "_ON_CARD", ("cuda",))
    with pytest.raises(ValueError, match="unsupported device"):
        meta[name]()
    assert card.calls == [] and getattr(ef, name).launches == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_refused_launch_raises_and_never_falls_back(card, name):
    """A launch the library refuses (here: cudaErrorInvalidConfiguration)
    raises, uncounted; the plain version is never tried."""
    card.err = 9
    with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
        _calls("meta")[name]()
    assert len(card.calls) == 1 and getattr(ef, name).launches == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_failed_build_raises(card, monkeypatch, tmp_path, name):
    """Without nvcc the first launch's build raises; nothing runs plain."""
    monkeypatch.setattr(ef, "_launcher", REAL_LAUNCHER)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found (needed to build the CUDA "
                           "kernels)")
    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _calls("meta")[name]()
    assert getattr(ef, name).launches == 0
    assert list(tmp_path.iterdir()) == []
