"""The port's CUDA kernels, both variants of each ("wgmma": TMA + wgmma;
"mma": cp.async + mma.sync), against their plain PyTorch versions, on the
card.

This file imports neither jax nor the JAX package, so it runs where the
card is and JAX is not installed:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Without a card its tests skip (the kernel has no CPU mode); the CPU tests
hold the plain version against the JAX reference."""

import numpy as np
import pytest
import torch

from neighborhoodwatch_tpu_torch.ops import knn as tknn
from neighborhoodwatch_tpu_torch.ops import screen_kernel as tsk

MEGA = tsk.MEGA


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _operands(q, b):
    qh = tsk.bf16_round(q)
    bhi = tsk.bf16_round(b).to(torch.bfloat16)
    return dict(qhi=qh.to(torch.bfloat16), qlo=(q - qh).to(torch.bfloat16),
                bhi=bhi, blo=(b - bhi.float()).to(torch.bfloat16),
                qn=(q * q).sum(1), bn=(b * b).sum(1))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,n_q,d,mega", [
    # D=200: not a multiple of 64 (TMA zero-fills the last chunk's columns),
    # and B = mega + 555 ends inside a 256-row step
    ("wgmma", 70, 200, MEGA), ("mma", 70, 200, MEGA),
    # D=45: rows TMA cannot describe, scalar loads
    ("mma", 50, 45, MEGA),
    # 17 query blocks: the cluster of 2 leaves one surplus block per mega
    ("wgmma", 1078, 72, MEGA),
    # an odd number of 128-row positions: the last 256-row step is half
    # inside the next mega
    ("wgmma", 33, 64, 5 * 128), ("mma", 33, 64, 5 * 128)])
def test_screen_kernel_matches_plain(cuda, variant, n_q, d, mega):
    """passes 1/2/3 x l2/dot/rdot on ragged Q and B, each kernel variant
    forced. Tolerance as in tests/test_torch_port_screen.py: masked
    entries masked on both sides, every distance within (PACK_EPS_REL + 4
    acc_rel(D)) x scale, and row ids different only between rows that
    close."""
    rng = np.random.default_rng(29)
    q = torch.from_numpy(rng.standard_normal((n_q, d)).astype(np.float32))
    b = torch.from_numpy(
        rng.standard_normal((2 * mega + 555, d)).astype(np.float32))
    q, b = q.to(cuda), b.to(cuda)
    ops = _operands(q, b)
    assert variant == "mma" or tsk.pick_variant(d, True) == "wgmma"
    q64, b64 = q.double(), b.double()
    qn, bn_max = (q64 ** 2).sum(1), (b64 ** 2).sum(1).max()
    scales = {"l2": qn + bn_max, "dot": qn.sqrt() * bn_max.sqrt(),
              "rdot": qn.sqrt()}
    before = tsk.screen_keys.launches
    before_v = tsk.screen_keys.launches_by_variant[variant]
    for passes in (1, 2, 3):
        for epi in tsk.EPILOGUES:
            with tsk.forced_variant(variant):
                k = tsk.screen_keys(**ops, mega_rows=mega, passes=passes,
                                    epilogue=epi)
            kp = tsk.screen_keys_plain(**ops, mega_rows=mega, passes=passes,
                                       epilogue=epi)
            dk, ik = tsk._decode_keys(k, epi, mega)
            dp, ip = tsk._decode_keys(kp, epi, mega)
            fin = torch.isfinite(dp)
            assert torch.equal(torch.isfinite(dk), fin)
            tol = (tsk.PACK_EPS_REL + 4 * tknn._acc_rel(d)) \
                * scales[epi][:, None]
            diff = torch.where(fin, (dk.double() - dp.double()).abs(),
                               torch.zeros_like(tol))
            assert bool((diff <= tol).all()), (passes, epi)
            swapped = fin & (ik != ip)
            assert bool((diff[swapped] <= tol.expand_as(diff)[swapped])
                        .all())
    assert tsk.screen_keys.launches == before + 9
    assert tsk.screen_keys.launches_by_variant[variant] == before_v + 9


@pytest.mark.cuda
def test_variant_follows_the_shape_and_a_wrong_force_raises(cuda):
    """Unforced, D=200 launches "wgmma" and D=45 "mma"; forcing "wgmma" on
    rows a tensor map cannot describe raises instead of falling back."""
    for d, variant in ((200, "wgmma"), (45, "mma")):
        ops = _operands(torch.randn(8, d, device=cuda),
                        torch.randn(MEGA, d, device=cuda))
        before = tsk.screen_keys.launches_by_variant[variant]
        tsk.screen_keys(**ops, mega_rows=MEGA, passes=1, epilogue="l2")
        assert tsk.screen_keys.launches_by_variant[variant] == before + 1
    with pytest.raises(RuntimeError, match="wgmma"):
        with tsk.forced_variant("wgmma"):
            tsk.screen_keys(**ops, mega_rows=MEGA, passes=1, epilogue="l2")


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(cuda):
    q = torch.zeros((4, 16), dtype=torch.bfloat16, device=cuda)
    qn = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        tsk.screen_keys(q.float(), q, q, q, qn, qn, MEGA, 1, "l2")
    with pytest.raises(ValueError, match="contiguous"):
        tsk.screen_keys(q.T.contiguous().T, q, q, q, qn, qn, MEGA, 1, "l2")


@pytest.mark.cuda
def test_auto_engine_launches_the_kernel(cuda):
    """knn(engine="auto") on CUDA tensors of >= 2 megas picks the screened
    engine, launches the kernel and matches the exact engine."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(40, 96, device=cuda, generator=g)
    b = torch.randn(2 * MEGA + 100, 96, device=cuda, generator=g)
    before = tsk.screen_keys.launches
    d, i = tknn.knn(q, b, 20)
    assert tsk.screen_keys.launches == before + 1
    de, ie = tknn.knn(q, b, 20, engine="exact")
    assert torch.equal(i, ie)
    assert float((d - de).abs().max()) <= 1e-4


def _maxsim_case(rng, Q, Tq, D, Td, dim, cuda):
    """Ragged masks, one empty doc, one NaN doc, one query with a single
    valid token."""
    q = rng.standard_normal((Q, Tq, dim)).astype(np.float32)
    d = rng.standard_normal((D, Td, dim)).astype(np.float32)
    qm = rng.random((Q, Tq)) < 0.8
    qm[:, 0] = True
    qm[0, 1:] = False
    dm = rng.random((D, Td)) < 0.7
    dm[:, 0] = True
    dm[5] = False
    d[9, min(2, Td - 1)] = np.nan
    dm[9, min(2, Td - 1)] = True
    return [torch.from_numpy(x).to(cuda) for x in (q, qm, d, dm)]


_MAXSIM_SHAPES = [
    (7, 12, 128, 3 * 8192 + 77), (32, 24, 128, 8192 + 5),
    (32, 64, 32, 700), (20, 180, 128, 300), (5, 16, 256, 8192),
    # Tq=24: two queries per 64 token rows, 48 of them live (the shape of
    # 17-token passages padded to a multiple of 8); in the wgmma variant
    # each of the two warpgroups holds such a pair
    (24, 32, 128, 8192), (24, 12, 128, 1500), (1, 1, 16, 130),
    # one 64-column chunk; dim 50 is padded to it
    (32, 16, 64, 8192 + 300), (9, 20, 50, 900)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant,Tq,Td,dim,D", [
    (v, *shape) for shape in _MAXSIM_SHAPES
    for v in (("wgmma", "mma") if -(-shape[2] // 16) * 16 in (64, 128)
              else ("mma",))])
def test_maxsim_kernel_matches_plain(cuda, variant, Tq, Td, dim, D):
    """maxsim_keys, each variant forced where the shape allows it (dim 32,
    16 and 256 take "mma" only), against maxsim_keys_plain at passes
    1/2/3: empty slots equal, decoded scores within (PACK_EPS_REL + 4
    maxsim_acc_rel(dim)) x (sum_t ||q_t|| x max ||d_s||) (fp32 sums in
    another order plus one key quantum), doc ids different only between
    docs that close. 37 queries leave a ragged last block, and at Tq 7 and
    24 an odd block count: a surplus block in the cluster of 2."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk
    rng = np.random.default_rng(31)
    q, qm, d, dm = _maxsim_case(rng, 37, Tq, D, Td, dim, cuda)
    before = tmk.maxsim_keys.launches
    before_v = tmk.maxsim_keys.launches_by_variant[variant]
    for passes in (1, 2, 3):
        ops = tmk.prepare_operands(q, qm, d, dm, passes)[:5]
        assert variant == "mma" or \
            tmk.pick_variant(ops[0].shape[2]) == "wgmma"
        with tmk.forced_variant(variant):
            keys = tmk.maxsim_keys(*ops, passes)
        torch.cuda.synchronize()
        plain = tmk.maxsim_keys_plain(*ops, passes)
        assert keys.shape == plain.shape
        tmk.candidates_agree(tmk.decode_keys(keys), tmk.decode_keys(plain),
                             q, qm, d, dm)
    assert tmk.maxsim_keys.launches == before + 3
    assert tmk.maxsim_keys.launches_by_variant[variant] == before_v + 3


@pytest.mark.cuda
def test_maxsim_wrapper_checks_its_inputs(cuda):
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk
    q = torch.zeros((4, 8, 32), dtype=torch.bfloat16, device=cuda)
    d = torch.zeros((64, 4, 32), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        tmk.maxsim_keys(q.float(), None, d, None, b, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tmk.maxsim_keys(q, None, d.transpose(0, 1).contiguous()
                        .transpose(0, 1), None, b, 1)
    with pytest.raises(ValueError, match="query tokens"):
        tmk.maxsim_keys(torch.zeros((4, 33, 32), dtype=torch.bfloat16,
                                    device=cuda), None, d, None, b, 1)
    # dim 32 cannot take the wgmma variant: a forced launch raises
    with pytest.raises(RuntimeError, match="wgmma"):
        with tmk.forced_variant("wgmma"):
            tmk.maxsim_keys(q, None, d, None, b, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_wgmma_keys_do_not_depend_on_the_cluster_size(cuda, cluster):
    """The "wgmma" variants at a fixed number of blocks per cluster against
    the launch function's own choice: the cluster only changes who loads a
    tile, so the keys are bit-identical. 330 queries are 6 query blocks (2
    surplus blocks at 4 per cluster); 37 queries of 7 tokens are 3 MaxSim
    blocks (1 surplus block at 2 and at 4)."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk
    rng = np.random.default_rng(37)
    q = torch.from_numpy(rng.standard_normal((330, 72)).astype(np.float32))
    b = torch.from_numpy(
        rng.standard_normal((MEGA + 555, 72)).astype(np.float32))
    ops = _operands(q.to(cuda), b.to(cuda))
    for passes in (1, 2, 3):
        with tsk.forced_variant("wgmma"):
            ref = tsk.screen_keys(**ops, mega_rows=MEGA, passes=passes,
                                  epilogue="l2")
        with tsk.forced_variant("wgmma", cluster=cluster):
            got = tsk.screen_keys(**ops, mega_rows=MEGA, passes=passes,
                                  epilogue="l2")
        assert torch.equal(got, ref), passes
    mq, mqm, md, mdm = _maxsim_case(rng, 37, 7, 8192 + 300, 12, 128, cuda)
    for passes in (1, 2, 3):
        mops = tmk.prepare_operands(mq, mqm, md, mdm, passes)[:5]
        with tmk.forced_variant("wgmma"):
            ref = tmk.maxsim_keys(*mops, passes)
        with tmk.forced_variant("wgmma", cluster=cluster):
            got = tmk.maxsim_keys(*mops, passes)
        assert torch.equal(got, ref), passes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layers,atol", [("float32", 12, 1e-5),
                                               ("bfloat16", 2, 2e-2)])
def test_e5_generator_on_the_card_matches_the_cpu(cuda, monkeypatch, dtype,
                                                  layers, atol):
    """The e5 generator (e5-small-v2's width, seeded random weights) on the
    card against the same generator on the CPU: fp32 within 1e-5 (TF32 is
    off), bf16 activations within 2e-2 on the unit-norm embeddings (the
    two devices round bf16 products at different places), over two chunks
    with a ragged tail."""
    import dataclasses
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    name = "intfloat/e5-small-v2"
    monkeypatch.setitem(tbert.E5_CONFIGS, name, dataclasses.replace(
        tbert.E5_CONFIGS[name], dtype=dtype, num_layers=layers))
    texts = [f"Sentence {i} about " + " ".join(f"w{j}" for j in range(i % 17))
             for i in range(100)]
    out = {}
    for dev in ("cpu", cuda):
        g = E5EmbeddingGenerator(name, max_length=64, seed=3, device=dev)
        out[str(dev)] = np.asarray(g.generate_embedding(texts))
        assert g.tokens_seen > 0 and not g.pretrained
    got, want = out["cuda"], out["cpu"]
    assert got.shape == want.shape == (100, 384)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-3)


# ------------------------------------------------------ masked attention

def _attention_case(rng, T, H, D, dtype, cuda):
    """(5, T, H, D) q, k, v and a ragged (5, T) mask: valid lengths 1, 37,
    T - 1, T and an all-padding row."""
    ops = [torch.from_numpy(rng.standard_normal((5, T, H, D))
                            .astype(np.float32)).to(cuda, dtype)
           for _ in range(3)]
    seg = torch.zeros((5, T), dtype=torch.int32)
    for i, n in enumerate((1, 37, T - 1, T, 0)):
        seg[i, :n] = 1
    return ops, seg.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 256, 512])
@pytest.mark.parametrize("H,D", [(12, 64), (16, 64), (16, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_attention_matches_plain(cuda, T, H, D, dtype):
    """The kernel against its plain version on every row, padding rows
    included (attention_kernel.outputs_agree: fp32 1e-5 abs, bf16 2 ulps
    of the row's largest |o|), with int32 and bool masks."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(T + H + D)
    (q, k, v), seg = _attention_case(rng, T, H, D, dtype, cuda)
    scale = 1.0 / D ** 0.5
    plain = tak.masked_attention_plain(q, k, v, seg, scale)
    for mask in (seg, seg.bool()):
        before = tak.masked_attention.launches
        got = tak.masked_attention(q, k, v, mask, scale)
        torch.cuda.synchronize()
        assert tak.masked_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        tak.outputs_agree(got, plain)


@pytest.mark.cuda
def test_masked_attention_reads_strided_operands_and_checks_inputs(cuda):
    """q, k, v as strided views of one (B, T, 3, H, D) tensor (no copy)
    give the contiguous operands' output, on both variants; what the kernel
    does not take raises (float64: no variant has it)."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((5, 128, 3, 12, 64))
                           .astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    seg = _attention_case(rng, 128, 12, 64, torch.bfloat16, cuda)[1]
    for variant in tak.VARIANTS:
        with tak.forced_variant(variant):
            got = tak.masked_attention(q, k, v, seg, 0.125)
            want = tak.masked_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), seg, 0.125)
        assert torch.equal(got, want)
    with pytest.raises(TypeError):
        tak.masked_attention(q, k.float(), v, seg, 0.125)
    with pytest.raises(TypeError):
        tak.masked_attention(q.double(), k.double(), v.double(), seg, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        tak.masked_attention(q[..., :32], k[..., :32], v[..., :32], seg,
                             0.125)
    with pytest.raises(ValueError, match="unit-stride"):
        tak.masked_attention(q.transpose(2, 3), k.transpose(2, 3),
                             v.transpose(2, 3), seg, 0.125)
    with pytest.raises(ValueError, match="sequence length"):
        tak.masked_attention(q[:, :96], k[:, :96], v[:, :96], seg[:, :96],
                             0.125)


@pytest.mark.cuda
def test_bert_encoder_launches_masked_attention_per_layer(cuda):
    """A flash encoder on the card: one launch per layer at T=128 (and its
    pooled embedding equals the CPU's within 1e-5 in fp32), none at T=64."""
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    cfg = tbert.BertConfig(hidden_size=256, num_layers=3, num_heads=4,
                           intermediate_size=512, dtype="float32",
                           attention_impl="flash")
    model = tbert.BertEncoder(cfg)
    tbert.init_params(model, seed=4)
    rng = np.random.default_rng(4)
    for T, launches in ((128, 3), (64, 0)):
        mask = np.zeros((6, T), np.int32)
        for i, n in enumerate((1, 20, T - 1, T, 0, T // 2)):
            mask[i, :n] = 1
        ids = torch.from_numpy(rng.integers(999, 30522, (6, T)) * mask)
        mask = torch.from_numpy(mask)
        out = {}
        for dev in ("cpu", cuda):
            model.to(dev)
            before = tak.masked_attention.launches
            with torch.no_grad():
                h = model(ids.to(dev), mask.to(dev))
                out[str(dev)] = tbert.mean_pool_normalize(h, mask.to(dev))
            torch.cuda.synchronize()
            want = launches if str(dev) != "cpu" else 0
            assert tak.masked_attention.launches == before + want
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], atol=1e-5,
                                   rtol=0)


@pytest.mark.cuda
def test_masked_attention_build_failure_raises(cuda, monkeypatch, tmp_path):
    """No nvcc on PATH or in the toolkit, nothing built yet: the flash
    encoder's first launch raises; nothing falls back to another path."""
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "TOOLKIT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    model = tbert.BertEncoder(tbert.BertConfig(
        hidden_size=128, num_layers=1, num_heads=2, intermediate_size=256,
        attention_impl="flash")).to(cuda)
    ids = torch.ones((2, 128), dtype=torch.long, device=cuda)
    before = tak.masked_attention.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        with torch.no_grad():
            model(ids, torch.ones_like(ids))
    assert tak.masked_attention.launches == before


# ------------------------------------------- masked attention, two variants

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "wgmma"])
@pytest.mark.parametrize("T", [128, 256, 384, 512])
@pytest.mark.parametrize("H,D", [(12, 64), (16, 64), (16, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_masked_attention_variants_match_plain(cuda, variant, T, H, D,
                                               dtype):
    """Each variant against the plain version on every row
    (outputs_agree: 2 ulps of the row's largest |o| in bf16 and fp16),
    int32 and bool masks of valid lengths 1, 37, T-1, T and 0, and its
    launches counted under its own name."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(T + H + D + 7)
    (q, k, v), seg = _attention_case(rng, T, H, D, dtype, cuda)
    scale = 1.0 / D ** 0.5
    plain = tak.masked_attention_plain(q, k, v, seg, scale)
    assert tak.pick_variant(T, D, dtype, True) == "wgmma"
    for mask in (seg, seg.bool()):
        before = dict(tak.masked_attention.launches_by_variant)
        with tak.forced_variant(variant):
            got = tak.masked_attention(q, k, v, mask, scale)
        torch.cuda.synchronize()
        after = tak.masked_attention.launches_by_variant
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == variant) for n in after}
        assert got.dtype == dtype and got.shape == q.shape
        tak.outputs_agree(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["mma", "wgmma"])
@pytest.mark.parametrize("seg_dtype", [torch.int32, torch.uint8])
def test_masked_attention_segment_ids_beyond_31(cuda, variant, seg_dtype):
    """Segment ids that share (id & 31) (1, 33, 65, 97, 129 and 7, 39):
    the tile skip's set test is conservative for them, so tiles of other
    segments are computed and masked, never skipped wrongly; runs of
    several lengths, every row against the plain version."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(31)
    B, T, H, D = 4, 512, 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D))
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for _ in range(3))
    ids = np.array([1, 33, 65, 97, 129, 7, 39, 0])
    seg = np.zeros((B, T), np.int64)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T), size=5, replace=False))
        for i, run in enumerate(np.split(np.arange(T), cuts)):
            seg[b, run] = ids[(i + b) % len(ids)]
    seg = torch.from_numpy(seg).to(cuda, seg_dtype)
    plain = tak.masked_attention_plain(q, k, v, seg.int(), 0.125)
    with tak.forced_variant(variant):
        got = tak.masked_attention(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    tak.outputs_agree(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T", [
    (3, 12, 384),      # 108 items: fewer than the SMs
    (7, 16, 512),      # 448 items, 4 query tiles a head: a grid of 131
                       # blocks (prime to 4)
    (133, 1, 128),     # 133 items: one block takes two
    (1, 5, 1024),      # 40 items of 8 key tiles
])
def test_masked_attention_wgmma_persistent_grid(cuda, B, H, T):
    """The persistent "wgmma" grid walks B*H*(T/128) items in a static
    stride: item counts that are not a multiple of the grid, fewer items
    than SMs, long rows; ragged masks, every row against the plain
    version, one launch."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(B * H + T)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, 64))
                                .astype(np.float32)).to(cuda, torch.float16)
               for _ in range(3))
    n = torch.from_numpy(rng.integers(1, T + 1, B)).to(cuda)
    seg = (torch.arange(T, device=cuda)[None] < n[:, None]).int()
    before = tak.masked_attention.launches_by_variant["wgmma"]
    got = tak.masked_attention(q, k, v, seg, 0.125)
    torch.cuda.synchronize()
    assert tak.masked_attention.launches_by_variant["wgmma"] == before + 1
    tak.outputs_agree(got, tak.masked_attention_plain(q, k, v, seg, 0.125))


@pytest.mark.cuda
def test_flash_fp16_encoder_launches_wgmma_per_layer(cuda):
    """A float16 flash encoder runs on the card (the gate's repair): one
    "wgmma" launch per layer at T=128 and 256 and none at T=64; the pooled
    embedding against the CPU's within 2e-3 (fp16 activations, the kernel
    and the plain version rounding p at other places)."""
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    cfg = tbert.BertConfig(hidden_size=256, num_layers=3, num_heads=4,
                           intermediate_size=512, dtype="float16",
                           attention_impl="flash")
    model = tbert.BertEncoder(cfg)
    tbert.init_params(model, seed=5)
    rng = np.random.default_rng(5)
    for T, launches in ((128, 3), (256, 3), (64, 0)):
        mask = np.zeros((6, T), np.int32)
        for i, n in enumerate((1, 20, T - 1, T, T // 2, T // 3)):
            mask[i, :n] = 1
        ids = torch.from_numpy(rng.integers(999, 30522, (6, T)) * mask)
        mask = torch.from_numpy(mask)
        out = {}
        for dev in ("cpu", cuda):
            model.to(dev)
            before = dict(tak.masked_attention.launches_by_variant)
            with torch.no_grad():
                h = model(ids.to(dev), mask.to(dev))
                out[str(dev)] = tbert.mean_pool_normalize(
                    h, mask.to(dev)).float()
            torch.cuda.synchronize()
            after = tak.masked_attention.launches_by_variant
            want = launches if str(dev) != "cpu" else 0
            assert after["wgmma"] == before["wgmma"] + want
            assert after["mma"] == before["mma"]
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], atol=2e-3,
                                   rtol=0)


@pytest.mark.cuda
def test_nothing_the_gate_admits_raises_in_the_kernel(cuda):
    """For head dims 32..256 x the config dtypes x sequences 64..1024:
    wherever the port's gate admits a shape on the card, the wrapper
    launches and agrees with the plain version; a head-dim-192 flash
    encoder on the card takes the written-out attention (no launch)."""
    from neighborhoodwatch_tpu_torch.models import bert as tbert
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as tak
    rng = np.random.default_rng(8)
    admitted = 0
    for head_dim in (32, 64, 96, 128, 192, 256):
        for dtype in ("bfloat16", "float16", "float32"):
            cfg = tbert.BertConfig(hidden_size=2 * head_dim, num_heads=2,
                                   dtype=dtype, attention_impl="flash")
            for T in (64, 128, 384, 1024):
                if not tak.use_flash(cfg, T, cuda):
                    continue
                admitted += 1
                q, k, v = (torch.from_numpy(
                    rng.standard_normal((2, T, 2, head_dim))
                    .astype(np.float32)).to(cuda, getattr(torch, dtype))
                    for _ in range(3))
                seg = (torch.arange(T, device=cuda)[None]
                       < torch.tensor([[T], [T // 3]], device=cuda)).int()
                got = tak.masked_attention(q, k, v, seg, head_dim ** -0.5)
                torch.cuda.synchronize()
                tak.outputs_agree(got, tak.masked_attention_plain(
                    q, k, v, seg, head_dim ** -0.5))
    assert admitted == 2 * 3 * 3          # head dims 64, 128 x 3 x 3
    model = tbert.BertEncoder(tbert.BertConfig(
        hidden_size=384, num_layers=2, num_heads=2, intermediate_size=256,
        attention_impl="flash")).to(cuda)
    before = tak.masked_attention.launches
    ids = torch.ones((2, 128), dtype=torch.long, device=cuda)
    with torch.no_grad():
        h = model(ids, torch.ones_like(ids))
    torch.cuda.synchronize()
    assert tak.masked_attention.launches == before
    assert bool(torch.isfinite(h).all())



@pytest.mark.cuda
def test_mesh_world_size_1_nccl_matches_single_device(cuda):
    """A single-rank NCCL group on the card (parallel/mesh.make_mesh(1)):
    sharded_knn over a base of 2 mega-tiles takes the screened engine and
    launches the screen kernel, ShardedStreamingMaxSim over one 8192-doc
    tile launches the MaxSim kernel, and both equal the single-device
    engines on unit rows and tokens: distances within 1e-5 and scores
    within 1e-3 (the tolerances of chip_smoke.py's phases 3 and 6), ids
    different only where those values tie."""
    import torch.distributed as dist
    from neighborhoodwatch_tpu_torch.ops import maxsim as tm
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as tmk
    from neighborhoodwatch_tpu_torch.parallel import mesh as pm
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as psk
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as psm
    made = not dist.is_initialized()
    mesh = pm.make_mesh(1, device=cuda)
    try:
        assert mesh.backend == "nccl" and not mesh.stage
        g = torch.Generator(device=cuda).manual_seed(5)
        q = torch.nn.functional.normalize(
            torch.randn(256, 64, device=cuda, generator=g), dim=1)
        b = torch.nn.functional.normalize(
            torch.randn(2 * MEGA, 64, device=cuda, generator=g), dim=1)
        before = tsk.screen_keys.launches
        d, i = psk.sharded_knn(q, b, 10, mesh)
        assert tsk.screen_keys.launches > before
        d1, i1 = tknn.knn(q, b, 10, engine="exact")
        torch.testing.assert_close(d, d1, atol=1e-5, rtol=0)
        assert bool(((i == i1) | ((d - d1).abs() <= 1e-5)).all())

        qq = torch.nn.functional.normalize(
            torch.randn(64, 32, 128, device=cuda, generator=g), dim=2)
        docs = torch.nn.functional.normalize(
            torch.randn(tmk.MEGA_DOCS, 16, 128, device=cuda, generator=g),
            dim=2)
        qm = torch.ones(qq.shape[:2], dtype=torch.bool, device=cuda)
        dm = torch.ones(docs.shape[:2], dtype=torch.bool, device=cuda)
        before = tmk.maxsim_keys.launches
        acc = psm.ShardedStreamingMaxSim(qq, qm, 10, mesh)
        acc.update(docs, dm)
        s, ids = acc.finalize()
        assert tmk.maxsim_keys.launches > before
        s1, i1 = tm.maxsim_topk(qq, qm, docs, dm, 10, engine="exact",
                                tile_docs=2048)
        s1, i1 = s1.cpu().numpy(), i1.cpu().numpy()
        np.testing.assert_allclose(s, s1, atol=1e-3)
        assert bool(((ids == i1) | (np.abs(s - s1) <= 1e-3)).all())
    finally:
        if made:
            dist.destroy_process_group()
