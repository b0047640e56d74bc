"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. setup: the card's name and power limit, torch/CUDA versions, and the
     build of the hand-written kernel (csrc/screen_keys.cu, nvcc into
     neighborhoodwatch_tpu_torch/_build/);
  2. kernel against plain: the screen kernel and its plain PyTorch version
     on the same bf16 operands, passes 1/2/3 x l2/dot/rdot, on ragged
     shapes (D=200 and D=45, padded nowhere) and one sub=112 wide-tier
     base;
  3. engine at full size: 10,000 queries x 1,000,000 base rows x 1536
     dims, k=100, sqeuclidean, unit Gaussian rows: knn(engine="auto") must
     pick the screened engine and launch the kernel; its result is held
     against the exact engine and its kernel against the plain version at
     these shapes; times are medians of 3 runs;
  4. pipeline: 1,000 x 320,000 x 1536 embeddings parquet -> compute_knn_ds
     (3 streamed screened batches) -> fvec/ivec/hdf5 export (hdf5 only
     where h5py is installed) -> validate_files_v0, and the ivec against
     the exact engine.
The line before the last is one JSON object with the kernel's numbers;
the last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line; without a CUDA card it exits 2.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def fail(msg, code=1):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def median_ms(fn, runs=3):
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def event_ms(fn, runs=3):
    import torch
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def screen_operands(q, b):
    import torch
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    qh = sk.bf16_round(q)
    bhi = sk.bf16_round(b).to(torch.bfloat16)
    return dict(qhi=qh.to(torch.bfloat16), qlo=(q - qh).to(torch.bfloat16),
                bhi=bhi, blo=(b - bhi.float()).to(torch.bfloat16),
                qn=(q * q).sum(1), bn=(b * b).sum(1))


def compare_keys(keys, keys_plain, epilogue, mega, q, b):
    """Kernel vs plain keys with the CPU test's tolerance: every decoded
    distance within (PACK_EPS_REL + 4 acc_rel(D)) x the metric's screen
    scale, row ids different only where the two distances are that close,
    masked entries masked on both sides. Returns (max_abs_err, swapped)."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.ops.knn import _acc_rel
    dk, ik = sk._decode_keys(keys, epilogue, mega)
    dp, ip = sk._decode_keys(keys_plain, epilogue, mega)
    fin = torch.isfinite(dp)
    if not torch.equal(torch.isfinite(dk), fin):
        raise AssertionError("kernel and plain disagree on masked entries")
    qn = (q.double() ** 2).sum(1)
    bn_max = (b.double() ** 2).sum(1).max()
    scale = {"l2": qn + bn_max, "dot": qn.sqrt() * bn_max.sqrt(),
             "rdot": qn.sqrt()}[epilogue][:, None]
    tol = (sk.PACK_EPS_REL + 4 * _acc_rel(q.shape[1])) * scale
    diff = torch.where(fin, (dk.double() - dp.double()).abs(),
                       torch.zeros_like(scale))
    if bool((diff > tol).any()):
        raise AssertionError(f"distance beyond tolerance: "
                             f"{float((diff - tol).max())}")
    swapped = fin & (ik != ip)
    return float(diff.max()), int(swapped.sum())


def phase_setup():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    # one nvcc per source, all started together (one source in this slice)
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t = time.perf_counter()
    _, report = cuda_build.build("screen_keys")
    sk.load_library()
    log(f"kernel build: {time.perf_counter() - t:.2f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def phase_kernel_vs_plain():
    import torch
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    g = torch.Generator(device="cuda").manual_seed(1)
    # D=200: the 16-byte cp.async loads; D=45: the scalar loads
    cases = [(70, 2 * sk.MEGA + 555, 200, sk.TB * sk.SUB_PER_MEGA),
             (50, sk.MEGA + 77, 45, sk.TB * sk.SUB_PER_MEGA),
             (33, sk._BIG_BASE + 4099, 200, sk.TB * 112)]
    worst = 0.0
    for qn_, bn_, d, mega in cases:
        q = torch.randn(qn_, d, device="cuda", generator=g)
        b = torch.randn(bn_, d, device="cuda", generator=g)
        ops = screen_operands(q, b)
        for passes in (1, 2, 3):
            for epi in sk.EPILOGUES:
                k = sk.screen_keys(**ops, mega_rows=mega, passes=passes,
                                   epilogue=epi)
                torch.cuda.synchronize()
                kp = sk.screen_keys_plain(**ops, mega_rows=mega,
                                          passes=passes, epilogue=epi)
                err, swapped = compare_keys(k, kp, epi, mega, q, b)
                worst = max(worst, err)
                log(f"  Q={qn_} B={bn_} D={d} mega={mega} passes={passes} "
                    f"{epi}: max |d_kernel - d_plain| {err:.3g}, swapped "
                    f"ids (within tolerance) {swapped}")
        del q, b, ops
    torch.cuda.empty_cache()
    return worst


def phase_engine(rec):
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    Q, B, D, k = 10_000, 1_000_000, 1536, 100
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(Q, D, device="cuda", generator=g)
    q /= q.norm(dim=1, keepdim=True)
    base = torch.empty(B, D, device="cuda")
    for s in range(0, B, 100_000):
        x = torch.randn(min(100_000, B - s), D, device="cuda", generator=g)
        base[s:s + len(x)] = x / x.norm(dim=1, keepdim=True)
        del x
    engine = K._select_engine("auto", B, q.device)
    if engine != "screened":
        raise AssertionError(f"auto picked {engine!r}, not 'screened'")

    # ---- the main-path call, counted ----
    sk.screen_keys.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    d_s, i_s = K.knn(q, base, k, engine="auto")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = sk.screen_keys.launches
    if launches < 1:
        raise AssertionError("knn(engine='auto') never launched the kernel")
    log(f"  knn(auto) -> engine {engine}, kernel launches {launches}, "
        f"first call {first_s:.3f} s")

    screened_ms = median_ms(lambda: K.knn(q, base, k, engine="auto"))
    _, _, diag = K.screened_knn_traced(q, base, B, 0, k, "sqeuclidean",
                                       "auto", with_diagnostics=True)
    log(f"  screened knn median of 3: {screened_ms:.1f} ms; repairs "
        f"class-A {diag[0]}, class-B {diag[1]}, whole-batch {diag[2]}")
    # where the call's time goes: its stages run one by one, medians of 3
    sub = sk.pick_sub(B, k, q_rows=Q)
    prep_ms = median_ms(lambda: K._prepare_arrays(base))
    bn_row, stats, bhi = K._prepare_arrays(base)

    def screen():
        return sk.screen_candidates(q, base, epilogue="l2",
                                    screen_precision="default", n_valid=B,
                                    bn_row=bn_row, bhi=bhi, sub=sub)
    screen_ms = median_ms(screen)
    cd, ci, _ = screen()
    _, m, block = K._screen_plan(B, k, D, sub, 1, lean=True)
    select_ms = median_ms(lambda: K._screened_select(
        q, base, cd, ci, k, m, "sqeuclidean", 1, block=block,
        base_stats=stats))
    del bn_row, stats, bhi, cd, ci
    log(f"  breakdown: prepare (norms, bf16 base, stats) {prep_ms:.1f} ms, "
        f"screen (operands + kernel + decode) {screen_ms:.1f} ms, select "
        f"(merge + re-rank + certificate) {select_ms:.1f} ms, repairs and "
        f"the rest {screened_ms - prep_ms - screen_ms - select_ms:.1f} ms")

    n_chk = 512
    exact_ms = median_ms(lambda: K.knn(q[:n_chk], base, k, engine="exact"))
    d_e, i_e = K.knn(q[:n_chk], base, k, engine="exact")
    a, b_ = i_s[:n_chk].cpu().numpy(), i_e.cpu().numpy()
    recall = np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b_)])
    same = float((a == b_).mean())
    dd = (d_s[:n_chk] - d_e).abs()
    ties_ok = bool(((torch.from_numpy(a != b_).cuda()) <= (dd <= 1e-5)).all())
    log(f"  exact engine on {n_chk} queries, median of 3: {exact_ms:.1f} ms;"
        f" recall {recall:.4f}, identical positions {same:.5f}, max |d_s - "
        f"d_e| {float(dd.max()):.3g}")
    if recall != 1.0 or not ties_ok:
        raise AssertionError("screened result differs from the exact engine")

    # ---- the kernel at the main path's shapes ----
    prep = K.prepare_base(base)
    mega = sk.TB * sub
    qh = sk.bf16_round(q)
    qhi = qh.to(torch.bfloat16)
    qlo = (q - qh).to(torch.bfloat16)
    qn = (q * q).sum(1)
    bn = prep.bn_row
    kernel = {}
    for passes in (1, 2, 3):
        blo = ((base - prep.bhi.float()).to(torch.bfloat16)
               if passes == 3 else None)

        def run(p=passes, bl=blo):
            return sk.screen_keys(qhi, qlo, prep.bhi, bl, qn, bn, mega, p,
                                  "l2")
        keys = run()
        kernel[passes] = event_ms(run)
        flops = 2.0 * Q * B * D * passes
        log(f"  screen kernel {passes}-pass (l2, sub={sub}): "
            f"{kernel[passes]:.1f} ms, {flops / kernel[passes] / 1e9:.1f} "
            f"TFLOP/s, bound {flops / PEAK_BF16_FLOPS * 1e3:.1f} ms")
        del blo
    keys = sk.screen_keys(qhi, qlo, prep.bhi, None, qn, bn, mega, 1, "l2")
    torch.cuda.synchronize()
    t = time.perf_counter()
    keys_plain = sk.screen_keys_plain(qhi, qlo, prep.bhi, None, qn, bn, mega,
                                      1, "l2")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err, swapped = compare_keys(keys, keys_plain, "l2", mega, q, base)
    log(f"  plain version at the same shapes: {plain_ms:.1f} ms; kernel vs "
        f"plain max |d| {err:.3g}, swapped ids (within tolerance) {swapped}")
    del keys, keys_plain
    torch.cuda.empty_cache()
    library_ms = event_ms(lambda: torch.mm(qhi, prep.bhi.T), runs=3)
    torch.cuda.empty_cache()
    log(f"  library yardstick torch.mm(bf16 q, bf16 base^T): "
        f"{library_ms:.1f} ms")

    n_mega = -(-B // mega)
    bytes_ = Q * D * 2 + B * D * 2 + Q * 4 + B * 4 + Q * n_mega * 512 * 4
    flops = 2.0 * Q * B * D
    bound_ms = max(bytes_ / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    rec.update(launches=launches, max_abs_err=err, ms=kernel[1],
               plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="operations" if flops / PEAK_BF16_FLOPS
               >= bytes_ / PEAK_BYTES else "bytes", library_ms=library_ms)
    log(f"  bound (1 pass): {bound_ms:.1f} ms ({rec['bound_by']})")
    del q, base, prep, d_s, i_s, d_e, i_e
    torch.cuda.empty_cache()


def phase_pipeline(rec, workdir):
    import torch
    import pyarrow.parquet as pq
    from neighborhoodwatch_tpu_torch.core.pipeline import compute_knn_ds
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.io.export import generate_output_files
    from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.validate import validate_files_v0
    Q, B, D, k = 1_000, 320_000, 1536, 100
    model = "text-embedding-ada-002"
    data_dir = naming.setup_model_output_folder(workdir, model, Q, B, k)
    qfile = naming.get_source_query_dataset_filename(data_dir, model, Q, D)
    bfile = naming.get_source_base_dataset_filename(data_dir, model, B, D)
    g = torch.Generator(device="cuda").manual_seed(3)

    def unit(n):
        x = torch.randn(n, D, device="cuda", generator=g)
        return (x / x.norm(dim=1, keepdim=True)).cpu().numpy()

    t = time.perf_counter()
    q = unit(Q)
    with ParquetStreamer(qfile, ["title", "question"]) as ps:
        ps.stream_to_parquet([["t", f"q{i}"] for i in range(Q)], q)
    with ParquetStreamer(bfile, ["title", "text"]) as ps:
        for s in range(0, B, 64_000):
            x = unit(min(64_000, B - s))
            ps.stream_to_parquet([["t", f"d{s + i}"] for i in range(len(x))],
                                 x)
    log(f"  wrote embeddings parquet ({Q} + {B} rows x {D}): "
        f"{time.perf_counter() - t:.1f} s")

    # h5py is not installed everywhere the card is: the hdf5 artifact is
    # written where it is, and the run says when it is not
    output_hdf5 = importlib.util.find_spec("h5py") is not None
    if not output_hdf5:
        log("  hdf5 export skipped: h5py is not installed on this machine")
    sk.screen_keys.launches = 0
    t = time.perf_counter()
    timer = compute_knn_ds(data_dir, D, qfile, Q, bfile, B, k=k,
                           initial_batch_size=100_000)
    files = generate_output_files(
        data_dir, model, D, bfile, qfile, B, Q,
        naming.get_partial_indices_filename(data_dir, -1),
        naming.get_partial_distances_filename(data_dir, -1), k,
        output_hdf5=output_hdf5)
    mismatches = validate_files_v0(data_dir, *files)
    wall = time.perf_counter() - t
    launches = sk.screen_keys.launches
    log(f"  compute_knn_ds + export + validate: {wall:.1f} s "
        f"(stages {timer.to_json()}), kernel launches {launches}, "
        f"validate_files_v0 mismatches {mismatches}")
    if launches < 1:
        raise AssertionError("the streamed pipeline never launched the kernel")
    if mismatches != 0:
        raise AssertionError(f"validate_files_v0 found {mismatches}")

    idx = fvec.read_vectors(files[2])
    base = pq.read_table(bfile).select(
        [f"embedding_{j}" for j in range(D)]).to_pandas().values
    d_e, i_e = K.knn(q, base.astype(np.float32), k, engine="exact")
    i_e = i_e.cpu().numpy()
    recall = np.mean([len(set(x) & set(y)) / k for x, y in zip(idx, i_e)])
    same = float((idx == i_e).mean())
    log(f"  ivec vs exact engine: recall {recall:.4f}, identical positions "
        f"{same:.5f}")
    if idx.shape != (Q, k) or recall != 1.0:
        raise AssertionError("exported neighbors differ from the exact engine")
    rec["launches"] += launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card", code=2)
    try:
        import neighborhoodwatch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    from neighborhoodwatch_tpu_torch import resolve_device
    resolve_device()
    assert "jax" not in sys.modules
    t0 = time.perf_counter()
    rec = {"name": "screen_keys", "route": "cuda",
           "source": "neighborhoodwatch_tpu_torch/csrc/screen_keys.cu",
           "replaces": "neighborhoodwatch_tpu/ops/screen_kernel.py:474"}

    t = time.perf_counter()
    card = phase_setup()
    log(f"phase 1 setup: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    worst = phase_kernel_vs_plain()
    log(f"phase 2 kernel vs plain: ok (max |d| {worst:.3g}), "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_engine(rec)
    log(f"phase 3 engine 10k x 1M x 1536: ok, "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="nw_smoke_", dir=HERE)
    try:
        phase_pipeline(rec, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase 4 pipeline: ok, {time.perf_counter() - t:.1f} s")
    assert "jax" not in sys.modules
    log(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
