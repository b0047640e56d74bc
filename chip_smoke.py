"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:
  1. setup: the card's name and power limit, torch/CUDA versions, and the
     build of the hand-written kernels (csrc/screen_keys.cu and
     csrc/maxsim_keys.cu, both on csrc/wgmma_mainloop.cuh,
     csrc/masked_attention.cu, csrc/verified_select.cu, the kNN core's
     csrc/prepare_base.cu, csrc/distance_tile.cu, csrc/rerank_rows.cu and
     csrc/split_distance.cu,
     the encoders' csrc/embed_layernorm.cu, csrc/add_layernorm.cu and
     csrc/masked_softmax.cu (on csrc/row_pass.cuh), and the MaxSim
     engines' csrc/maxsim_dense.cu and csrc/maxsim_pairs.cu (variants
     "ffma" on csrc/maxsim_tile.cuh and "split" on csrc/maxsim_split.cuh),
     and the decoder's csrc/decoder_passes.cu (on csrc/row_pass.cuh),
     one nvcc each, started together, into
     neighborhoodwatch_tpu_torch/_build/) with ptxas' registers and spills
     per kernel variant (a spill fails the run);
  2. kernel against plain: the screen kernel and its plain PyTorch version
     on the same bf16 operands, passes 1/2/3 x l2/dot/rdot, on ragged
     shapes (D=200 and D=45, padded nowhere; a query count that leaves a
     surplus cluster block) and one sub=112 wide-tier base; every case on
     the variant its shape takes ("wgmma", or "mma" for D=45) and, where
     that is "wgmma", on "mma" too;
  3. engine at full size: 10,000 queries x 1,000,000 base rows x 1536
     dims, k=100, sqeuclidean, unit Gaussian rows: knn(engine="auto") must
     pick the screened engine and launch the "wgmma" kernel, F1 and F3 and
     K7 (the merge's top-m), each counted from 0; its result is
     held against the exact engine and its kernel against the plain version
     at these shapes; the two variants are timed in turns (mma, wgmma,
     wgmma, mma) at 1/2/3 passes, here and at the streamed batch's shape
     (1,000 x 100,000, sub=28); times are medians of 3 runs;
  4. pipeline: 1,000 x 320,000 x 1536 embeddings parquet -> compute_knn_ds
     (3 streamed screened batches, each launch timed by CUDA events) ->
     fvec/ivec/hdf5 export (hdf5 only where h5py is installed) ->
     validate_files_v0, and the ivec against the exact engine;
  5. MaxSim kernel against plain: maxsim_keys and its plain PyTorch
     version on the same prepared operands, passes 1/2/3 x Tq 7/24/32 x Td
     12/24/64/180 x dim 128/32/256/64 with masked tokens, empty docs and a
     NaN doc, plus one case of 3+ mega-tiles on a ragged doc count; every
     case on the variant its shape takes ("wgmma" at dim 128 and 64, "mma"
     at 32 and 256) and, where that is "wgmma", on "mma" too;
  6. MaxSim engine at ColBERT's width: 1,000 query passages x 32 tokens x
     128 dims, k=100, against 200,000 docs x 16 tokens and 50,000 docs x 64
     tokens: maxsim_topk(engine="auto") must pick the screened engine and
     launch the "wgmma" kernel; result held against the exact engine on 64
     queries; the two variants timed in turns at 1/2/3 passes beside the
     bound, the plain version, a product-only torch.mm yardstick (the
     whole tile loop, measured), the call's stages; then
     StreamingMaxSim over the first corpus in 8192-doc tiles; every path
     counts M1 and M2 from 0 (ops/maxsim_fused.py, phase 17), per variant
     too, and must launch M1 once a tile of every exact-engine call and
     every exact tail tile, M2 once or twice a screened select, every
     launch on the default variant ("split"); the one-shot call's, the
     exact engine's and the stream's top-k held against float64 MaxSim on
     16 queries (tie-tolerant at 1e-3); the exact engine (64 queries) and
     one stream tile's call and its exact engine are timed on M1 / M2 / K7
     and on the plain versions in turns;
  7. ck: (a) measured once, the ColBERT encoder loop as ck's source loop
     runs it (one passage a generate_embedding call) op by op ("eager"):
     host ms a forward split into tokenize, launch and copy, and the
     card's idle share and kernels a forward from a device_trace; then the
     port's ck_main --maxsim --synthetic --post-validation at BERT-base
     width with seeded random weights (bf16 activations) over 17,408 base
     passages (2 full 8192-doc tiles + a padded tail), every forward a
     CUDA graph replay (models/graphed.py; captures within the bound), and
     every forward launching E1 once, E2 twice a layer and E3 once a layer
     (counted from 0 around ck_main; a capture's warm-up forwards count),
     512 of its base calls traced for the graphed idle share (both traces
     must show E1-E3 and no ATen softmax or layer_norm kernel), the
     sections' seconds and the encoder's tokens/s, then
     validate_maxsim_files, the exported neighbours against the exact
     MaxSim engine on the same parquet and against float64 MaxSim on 16
     queries (M1 and M2 counted as in 6), and
     both kernel variants against
     the plain version on the run's own queries and first tile at 3/2/1
     passes;
  8. nw: (a) measured once, the e5 encoder loop as nw's base set runs it
     (10,000 of its sentences a call) op by op ("eager"), as in 7(a); then
     the port's nw_main --synthetic --post-validation --trace-dir at
     e5-large-v2's full width (1024 hidden, 24 layers, 16 heads, FFN 4096,
     bf16, seeded random weights, hash tokenizer), every forward a CUDA
     graph replay launching E1-E3 as in 7, one 10,000-sentence base call
     traced for the graphed idle share (both traces, (a)'s and this one,
     must show E1-E3 and no ATen softmax or layer_norm kernel; the kernels
     a forward are printed), over 1,000 queries and
     100,000 base sentences, k=100, through the table path (compute_knn ->
     partial files -> merge): the screened engine must launch the "wgmma"
     kernel at D=1024, and F1, F4 (the fallback's tiles) and F3, counted
     from 0 around nw_main; the ivec is held against the exact engine on the
     same parquet (tie-tolerant recall 1.000), validate_files_v0 must find
     0 mismatches, and the kernel is held against its plain version on the
     run's own queries and first mega-tile at 1/2/3 passes. Prints the
     sections' seconds, the encoder's tokens/s, the kNN stages, the
     class-A/B repairs, the trace's top CUDA kernels, and the run's kNN
     call timed at each screen tier beside the exact engine;
  9. nw-tools: the port's tools.main knn over phase 8's fvec files (its
     ivec must equal phase 8's, tie-tolerant) and recall of one against
     the other (1.000);
 10. attention (csrc/masked_attention.cu, the BERT encoders under
     attention_impl="flash"; variants "wgmma", TMA + wgmma, warp-
     specialized and persistent, and "mma"): (a) both variants against the
     plain version on ragged masks (valid lengths 1, 37, T-1, T and an
     all-padding row) at T 128/256/512 x (H, D) (12, 64)/(16, 64)/(16,
     128) x bf16/fp16 (and fp32 on "mma"), every row; (b) the e5-large-v2
     generator at its published width (24 layers, bf16, seeded random
     weights, hash tokenizer) with the flash config and with "auto" on one
     state, ~131,072 ragged tokens per forward in buckets 128, 256 and
     512: 24 "wgmma" launches per forward (a graph replay, counted at
     replay), 0 in bucket 64, tokens/s of both, the pooled embeddings
     against each other; (c) the ColBERT generator at bert-base width,
     flash against "auto" on one state over passages in bucket 128 (12
     "wgmma" launches per forward, replays after a first, capturing
     call); (d) at
     e5-large's shapes (B = 131072/T, H=16, D=64) the two variants by CUDA
     events around 10 calls back to back, in turns, beside the bound, the
     plain version, the written-out attention and torch's
     scaled_dot_product_attention with the segment mask (a yardstick the
     port never calls);
 11. mesh (parallel/, torch.distributed): (a) at world size 1 over NCCL,
     ShardedStreamingKNN over phase 3's data in 4 batches of 250,000 rows
     and sharded_knn (both must launch the "wgmma" screen kernel), ring_knn
     on 1,000 of its queries, each against phase 3's knn() result
     (tie-tolerant) with its seconds beside phase 3's; (b)
     compute_knn_ds(mesh) over phase 4's parquet (export, validate_files_v0,
     the ivec against phase 4's) and nw_main --mesh 1 over a copy of phase
     8's embeddings (the ivec against phase 8's); (c)
     ShardedStreamingMaxSim over phase 6's 200,000 x 16 corpus in 8192-doc
     tiles against phase 6's StreamingMaxSim, and compute_maxsim_knn(mesh)
     over phase 7's parquet against phase 7's export; (d) two ranks of this
     script on the one card over gloo (`--mesh-rank`, a deadline, a failed
     rank fails the run): sharded_knn and ShardedStreamingKNN at 10,000 x
     200,000 x 1536 and ShardedStreamingMaxSim over 2 tiles of 2 x 8192
     docs, each against the world-size-1 result on the same seeded inputs;
     their seconds are no speed figures. The launches of every mesh path,
     counted from 0, go into the kernels line as `mesh_launches`.
 12. the port's last modules: (a) phase 3's first 250,000 base rows
     (1536 wide) and 1,000 of its queries written as fvec by the native
     engine (native/nwio.cpp, built at first use; codec() must say
     "native") and by the numpy codec (NW_TPU_NATIVE=0), the files equal
     byte for byte, read back (from the page cache) and streamed by both,
     the arrays equal; (b) nw-tools knn --batch-rows 100000 over them,
     native stream and numpy codec in turns after an untimed first run
     (numpy): 2 "wgmma" launches a run (the 50,000-row tail takes the
     verified engine), ivecs and distances equal;
     (c) screened_knn, the host-repair engine, at phase 3's 10,000 x
     1,000,000 x 1536, k=100: 1 "wgmma" launch, held against phase 3's
     knn() (tie-tolerant), its ms; (d) the encoder probe
     (probes/encoder_probe.py): e5-large-v2 at seq 256 and 512, e5-base-v2
     at 512, "auto" and "flash", ~131,072 tokens a forward: "flash" 1
     "wgmma" launch a layer a forward, "auto" none. The launches go into
     the kernels line as `port_launches` and `probe_launches`.
 13. the verified engine's select (csrc/verified_select.cu, K7, through
     ops/verified_kernel.py; variants "adaptive", the default: rows in
     registers, an adaptive first digit, a persistent grid prefetching the
     next row by bulk copies, clusters for wide or few rows, and "radix",
     the first version): (a) both variants against the plain version on
     fp32 distance tiles of unit Gaussian rows at 1536 dims, 1,000 x 8,192,
     128 x 32,768 (the class-B repair's tile), 512 x 8,192 with every base
     row three times (planted ties) and 16 x 262,144 (an escalation's
     tile), k 1/100/1024: positions, distance bits and proof verdicts
     equal, no row fallen back, and a planted candidate set (column 0
     dropped, every row's minimum) on the persistent path and on both
     cluster paths, whose every row must fail and fall back to the exact
     selection; the variants timed in turns (radix, adaptive, adaptive,
     radix), each a CUDA graph of 10 calls (the card's time alone) and
     one call through the wrapper (the host's share included), beside the
     plain version, torch.topk (library_ms), the exact engine's stable
     sort and the bytes bound; (b) knn(engine="verified") against
     "exact" at phase 3's data on 512 queries (tie-tolerant), their ms and
     the exact engine with torch.topk as its select, beside the fp32
     product's bound; (c) phase 8's 1,000 x 100,000 x 1024 screened call
     with its exact fallback on the stable sort and on K7, in turns, and
     the K7 launches of that call; K7's launches in phase 8's nw_main (the
     kernels line's `launches`, all of them "adaptive") and on every other
     path that runs it (`launches_by_path`, `launches_by_path_variant`);
     (d) precision "default" and "high" on the exact engine at (b)'s
     shape: ms and max |d - d_highest|. (b) and (c) count F1 and F4.
 14. the encoders' compiled forward (models/graphed.py: a CUDA graph per
     padded shape), at published widths with seeded random weights: (b)
     e5-large-v2 at (64, 32), (64, 128), (64, 512) and a 37-row tail padded
     to 64, the ColBERT generator at (1, 32), a 5-row batch padded to 8 in
     bucket 64 and 64 passages in bucket 220, and the e5-large flash
     config in buckets 128, 256 and 512: each graph against the eager
     forward at the same padded shape bit for bit, padded against unpadded
     (max |d| <= 5e-2, cosine >= 0.999), eager and graph in turns: host ms
     a forward over a synced loop, device ms by CUDA events, tokens/s, the
     tensor-core bound (FLOPs / 989 TFLOP/s); E1-E3's launches in one
     replay (E1 1, E2 2 x layers, E3 layers; E3 0 under "flash"); at e5
     64 x 32 / 128 / 512 and ColBERT 64 x 220 the forward on E1-E3 against
     the plain chain (a second graph captured under
     encoder_fused.forced_variant("plain")), outputs within 5e-2 and
     cosine 0.999, and the default variants (E1 and E2 "rowpass", E3
     "staged")
     against "rowpass" alone (PR 13's kernels: a third graph captured
     under forced_variant("rowpass")), outputs bit for bit; device ms in
     turns (plain, rowpass, default, default, rowpass, plain);
     (c)
     every shape replayed out of its capture order, bit for bit; (d) K6
     launches per replay under "flash" (24, all "wgmma"); (e)
     generate_embedding over 10,000 base
     sentences and encode_passages under set_sync_debug_mode("error"),
     the readback alone exempt; (f) phase 8(a)'s loop, graphed.
 15. the kNN core's fused kernels (ops/fused_core.py), each against its
     plain version (the op-by-op code) at the main path's shapes and timed
     in turns (plain, kernel, kernel, plain) beside its bytes bound: (a) F1
     prepare_base (csrc/prepare_base.cu) at phase 3's 1,000,000 x 1536
     base: bhi bit for bit, bn_row within (dim + 16) 2^-24, the statistics
     at or above their float64 truth, the rows whose norm bits differ from
     torch's row sums, and the norms-only launch; (b) F2 distance_tile
     (csrc/distance_tile.cu) at 512 x 8,192 (1536 dims: the 512 x 1M
     engines' tile) and 1,000 x 8,192 (1024: nw's fallback), every metric
     and a shifted mask bit for bit, and the distances that differ from
     the old path's (torch's row sums as norms); (c) F3 rerank_rows
     (csrc/rerank_rows.cu) on knn(auto)'s own 10,000 x 256 candidates and
     on nw's own (phase 8's embeddings, 1,000 x m over 100,000 rows):
     "rowwise" (the default) and "grouped" (the pairs sorted by id on the
     card, each distinct row read once) bit for bit, within 1e-5 of the
     plain version (the gather, torch.bmm), plain, rowwise and grouped in
     turns, beside the bound over the distinct rows and over every
     candidate row (ids int64: 12 bytes a pair with the distance); (d) the
     merge's top-m on K7 against the stable sort, equal and in turns; (e)
     F4 split_distance (csrc/split_distance.cu) at the fallback's tiles
     (10,000 x 8,192 at 1536 and 1024 dims) and nw's (1,000 x 8,192 at
     1024): within its error model of float64 and within SPLIT_ULPS ulps
     of its plain version on sampled rows, where the plain version
     without its third pieces (bf16x3) must not be, two launches bit for
     bit, timed in turns with the path it replaced (the library's fp32
     product and F2), beside the six-product bound and the plain
     version; its record counts the split pass's launches too.
     Their records join the kernels line, launches from phase 8's nw_main
     and per path, F3's per variant (phases 3 and 8 fail unless every F3
     launch went to its default, "rowwise").
 16. the encoders' fused kernels (ops/encoder_fused.py), each against its
     plain version (the op-by-op chain) on bf16 inputs at the published
     shapes: e5-large-v2 64 x 32 / 128 / 512 (1024 hidden, 16 heads),
     ColBERT 64 x 256 and ck's one-passage replay 1 x 32 (768, 12), ragged
     masks with a pad row: E1 embed_layernorm (csrc/embed_layernorm.cu),
     E2 add_layernorm (csrc/add_layernorm.cu), E3 masked_softmax
     (csrc/masked_softmax.cu), within one bf16 ulp (plus 1e-5 for the
     LayerNorms' cancellations near 0). Each kernel's variants "rowpass"
     and "staged" equal bit for bit on every input, then plain, rowpass
     and staged in turns, cold (rotating_ms: a CUDA graph of calls, each
     on its own inputs, inputs and outputs four times the L2 or more) and
     hot (graph_ms: one input again and again, as the forward finds E2's
     operands just written), beside the bytes bound (E1's at 1 x 32 too)
     and, for E2 and E3, a yardstick never called by the port (ATen's
     layer_norm of one bf16 (rows, n) tensor, torch.softmax of the bf16
     logits: one library row pass over about the same bytes, not the same
     function); where E1's plan sends a shape to "rowpass" (one full pass
     a block: nw's 64 x 32) the staged kernel is timed past that rule
     too. Their records join the kernels line: ms at nw's 64 x 32 (the
     default variant; ms_rowpass and ms_staged each variant's), launches
     from phase 8's nw_main, per path (7, 8) and per replay (14), per
     variant; phases 7 and 8 fail unless every E1-E3 launch went to its
     default (E1 and E2 "rowpass", E3 "staged"), or to "rowpass" for a
     shape the launch plan sent there.
 17. the MaxSim engines' fused kernels (ops/maxsim_fused.py), each in both
     variants: "split" (the default: csrc/maxsim_split.cuh, fp32-exact
     bf16x6 products on the tensor cores, 16-dim chunks promoted into fp32,
     on the launch plan of maxsim_fused.plan) and "ffma" (csrc/
     maxsim_tile.cuh: fp32 FMA on the CUDA cores), against the plain
     version (the library product or the gather, op by op) and a float64
     oracle, with garbage planted (NaN and inf in valid and masked tokens,
     an all-masked query and doc, ids outside the docs): M1 maxsim_dense
     (csrc/maxsim_dense.cu) at the stream's exact fallback step (718 x 32
     x 128 against 2,048 x 16), phase 6(b)'s Td = 64, the exact engine's
     128-doc tile and a ragged 13 / 7 / 96 shape (every precision on the
     small ones); M2 maxsim_pairs (csrc/maxsim_pairs.cu) at the re-rank's
     1,000 x 256 candidates over 8,192 x 16 and 50,000 x 64 docs, the
     class-A repair's 512 bin members a query and a ragged shape: scores
     within 1e-3 of the plain version, M1's -1e30 positions bit for bit,
     M2's NaN positions, two launches bit for bit, and the error against
     float64 (in units of 2^-24 sum_t sum_k |q_tk d_sk| at the selected
     pair) within each variant's error model (the "split" plan's bound or
     dim, plus 64 for the token sum); the dots of an adversarial case
     (heavy cancellation, exponents over 2^-20 .. 2^20, 3.3e38 x 1e-30)
     within the model; plain, ffma and split timed in turns at every
     shape and precision (a CUDA graph of calls, each on its own inputs
     above the L2; phase 6(b)'s shapes issued from the host) beside the
     fp32 FFMA bound and the split's tensor bound, with a product-only
     yardstick (one torch.mm of M1's fp32 operands, TF32 off, never
     called by the port). Their records join the kernels line: launches
     from phase 7's ck_main, per path (6, 7, 11) and per variant.
 18. the decoder embedder's kernels at e5-mistral-7b-instruct's widths,
     bf16, 64 texts at bucket 512: D1 add_rmsnorm, D2 rope and D3 swiglu
     (csrc/decoder_passes.cu) and K6's causal grouped-query mode (32 query
     heads over 8 K / V heads, head dim 128; also at 2 x 4,096, the model
     card's limit) against their plain versions on the same inputs, at
     the card tests' tolerances, each with a control the comparison must
     catch (the norm without the add, the angles one position on, the
     SwiGLU halves swapped, attention without the causal mask); each
     timed cold in turns with its plain version beside its bound. Then
     the main path: E5EmbeddingGenerator for e5-mistral-7b-instruct
     (seeded weights, all 32 layers) over 64 documents at bucket 512,
     with the launch counts set to 0 just before: 65 D1, 32 D2, 32 D3 and
     32 causal "wgmma" K6 launches a forward, the profiler counters of
     one replay the same, the replay equal bit for bit to the eager
     forward. Their records join the kernels line.
The line before the last is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line; without a CUDA card it exits 2.
"""

import contextlib
import filecmp
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published H100 SXM peaks: dense bf16 tensor-core rate, fp32 outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20     # the H100's L2 cache
# calls per CUDA-event timing where one call is a fraction of a millisecond
REPS = 10


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


def turns_ms(mod, fn):
    """`fn` under the module's two kernel variants in turns (mma, wgmma,
    wgmma, mma), each a median of 3 by CUDA events; returns the mean of
    each variant's two medians as (mma_ms, wgmma_ms)."""
    got = {"mma": [], "wgmma": []}
    for name in ("mma", "wgmma", "wgmma", "mma"):
        with mod.forced_variant(name):
            fn()                                    # warm-up
            got[name].append(event_ms(fn))
    return float(np.mean(got["mma"])), float(np.mean(got["wgmma"]))


def cluster_sweep_ms(mod, fn):
    """`fn` under the "wgmma" variant at 1, 2 and 4 blocks per cluster (the
    launch function's own choice is what every other timing uses), each a
    median of 3 by CUDA events, run twice in turns; returns {size: ms}."""
    got = {1: [], 2: [], 4: []}
    for size in (1, 2, 4, 4, 2, 1):
        with mod.forced_variant("wgmma", cluster=size):
            fn()
            got[size].append(event_ms(fn))
    return {size: float(np.mean(v)) for size, v in got.items()}


def kernel_name(sym):
    """A kernel's name from its mangled symbol: `<length><name>` after the
    anonymous namespace's prefix, else the first `..._kernel`, else the
    symbol."""
    m = re.search(r"_GLOBAL__N_1(\d+)", sym)
    if m:
        return sym[m.end():m.end() + int(m.group(1))]
    m = re.search(r"([a-z_]+_kernel)", sym)
    return m.group(1) if m else sym


def ptxas_report(name, report):
    """ptxas -v per kernel of one source: variant, pass count, registers,
    spills. Raises on any spill."""
    entry, spills = None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            if name in ENCODER_KERNELS or name == "decoder_passes":
                # E1-E3, D1-D3: the kernel's name, then its template
                # arguments: the activation dtype, ints, flags
                dtype = ("bf16" if "bfloat16" in sym else "fp16" if
                         "__half" in sym else "fp32")
                targs = re.search(r"I(?:13__nv_bfloat16|6__half|f)"
                                  r"((?:L[ib]\d+E)*)E", sym)
                args = re.findall(r"\d+", targs.group(1)) if targs else []
                staged = " staged" if "_staged" in sym else ""
                kernel = kernel_name(sym) if name == "decoder_passes" \
                    else name
                entry = f"{kernel}{staged}<{', '.join([dtype, *args])}>"
            elif name in FUSED_KERNELS or name in MAXSIM_KERNELS:
                # F1-F4, M1-M2: the kernel's name, then its template
                # arguments
                targs = re.search(r"I((?:L[ib]\d+E)+)E", sym)
                args = re.findall(r"\d+", targs.group(1)) if targs \
                    else []
                entry = f"{kernel_name(sym)}<{', '.join(args)}>"
            elif "verified_select" in sym:
                # the adaptive variant's template arguments: resident keys,
                # cluster
                targs = re.search(r"ILb(\d)ELb(\d)E", sym)
                entry = ("radix" if targs is None else
                         f"adaptive<registers={targs.group(1)}, "
                         f"cluster={targs.group(2)}>")
            elif "masked_attention" in sym:
                # the kernel's name, then the mangled template arguments:
                # dtype, head dim
                dim = re.search(r"Li(\d+)E", sym).group(1)
                dtype = ("bf16" if "bfloat16" in sym else
                         "fp16" if "__half" in sym else "fp32")
                variant = "wgmma" if "wgmma" in sym else "mma"
                entry = f"{variant} {dtype}, D={dim}"
            else:
                variant = "wgmma" if "wgmma" in sym else "mma"
                # the mangled template arguments: passes[, epilogue]
                targs = re.search(r"I((?:Li\d+E)+)E", sym)
                args = re.findall(r"\d+", targs.group(1)) if targs \
                    else ["?"]
                entry = f"{variant}<{', '.join(args)}>"
        elif "spill" in line and entry:
            spills = line.strip()
            if "0 bytes spill stores, 0 bytes spill loads" not in spills:
                raise AssertionError(f"{name} {entry} spills: {spills}")
        elif "registers" in line and entry:
            log(f"  ptxas {name} {entry}: "
                f"{line.split(':', 1)[1].strip()}; {spills}")
            entry = None
        elif "arning" in line or "(C7" in line:
            log(f"  ptxas {name}: {line.strip()}")


# the kNN core's fused kernels (ops/fused_core.py): F1, F2, F3, F4
FUSED_KERNELS = ("prepare_base", "distance_tile", "rerank_rows",
                 "split_distance")
# their launches on each path that runs them, counted from 0 just before
# the path and read just after: {path: {kernel: launches}}, with F3's per
# variant and the shapes its plan sent to "rowwise" (shape: reason)
FUSED_LAUNCHES = {}


@contextlib.contextmanager
def fused_counted(path):
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    fc.reset_launches()
    yield
    FUSED_LAUNCHES[path] = {
        "prepare_base": fc.prepare_base.launches,
        "distance_tile": fc.distance_tile.launches,
        "rerank_rows": fc.rerank_rows.launches,
        "split_distance": fc.split_distance.launches,
        "split_distance_pieces": fc.split_distance.split_launches,
        "rerank_rows_by_variant": dict(fc.rerank_rows.launches_by_variant),
        "rerank_rows_rowwise_plans": {
            str(k): v for k, v in fc.rerank_rows.rowwise_plans.items()}}


def require_fused(path, kernels):
    """Fail unless every kernel in `kernels` launched on `path`, and every
    F3 launch there went to its default variant (fused_core.
    DEFAULT_VARIANT: nothing on the main path forces one) or, were the
    default "grouped", to "rowwise" for a shape the plan sent there; never
    the plain version."""
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    got = FUSED_LAUNCHES[path]
    missing = [n for n in kernels if got[n] < 1]
    if missing:
        raise AssertionError(f"{path} never launched {missing}: {got}")
    by, plans = got["rerank_rows_by_variant"], got["rerank_rows_rowwise_plans"]
    default = fc.DEFAULT_VARIANT["rerank_rows"]
    other = "rowwise" if default == "grouped" else "grouped"
    if by["plain"] or by[other] and not (other == "rowwise" and plans):
        raise AssertionError(f"{path}: F3 launched {by} (plan's rowwise "
                             f"shapes {plans}), not its default "
                             f"{default!r} alone")


# the MaxSim engines' fused kernels (ops/maxsim_fused.py): M1, M2
MAXSIM_KERNELS = ("maxsim_dense", "maxsim_pairs")
# their launches on each path that runs them, counted from 0 just before
# the path and read just after, beside what the path asked of them: M1
# launches the exact engine's tiles call for (`dense_expected`: one a
# tile of every _exact_topk call), and the screened selects
# (`select_calls`; M2 launches once a select, once more where it repairs
# bins): {path: {name: count}}
MAXSIM_LAUNCHES = {}


@contextlib.contextmanager
def maxsim_counted(path):
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    exact, select = M._exact_topk, M._maxsim_select
    rec = {"dense_expected": 0, "exact_calls": 0, "select_calls": 0}

    def exact_topk(queries, q_mask, docs, d_mask, k, tile_docs, *a, **kw):
        rec["exact_calls"] += 1
        rec["dense_expected"] += -(-docs.shape[0] // tile_docs)
        return exact(queries, q_mask, docs, d_mask, k, tile_docs, *a, **kw)

    def maxsim_select(*a, **kw):
        rec["select_calls"] += 1
        return select(*a, **kw)
    mf.reset_launches()
    M._exact_topk, M._maxsim_select = exact_topk, maxsim_select
    try:
        yield rec
    finally:
        M._exact_topk, M._maxsim_select = exact, select
    MAXSIM_LAUNCHES[path] = {
        **{n: getattr(mf, n).launches for n in MAXSIM_KERNELS},
        **{f"{n}_by_variant": dict(getattr(mf, n).launches_by_variant)
           for n in MAXSIM_KERNELS},
        **{f"{n}_ffma_plans": {str(k): v for k, v in
                               getattr(mf, n).ffma_plans.items()}
           for n in MAXSIM_KERNELS}, **rec}


def require_maxsim(path, tail_tiles=0):
    """Fail unless `path` launched M1 once a tile of every exact-engine
    call (and once for each of its `tail_tiles` exact stream tiles) and M2
    once or twice a screened select, and at least one of them, every
    launch on its default variant (DEFAULT_VARIANT) but for the shapes
    the "split" plan sent to "ffma" (none at these dims and token counts);
    print the counts."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    got = MAXSIM_LAUNCHES[path]
    dense, pairs = got["maxsim_dense"], got["maxsim_pairs"]
    want = got["dense_expected"] + tail_tiles
    sel = got["select_calls"]
    if dense != want or not sel <= pairs <= 2 * sel or dense + pairs < 1:
        raise AssertionError(f"{path}: M1 launched {dense} (expected {want})"
                             f", M2 {pairs} ({sel} screened selects): {got}")
    for n in MAXSIM_KERNELS:
        by = got[f"{n}_by_variant"]
        if by[mf.DEFAULT_VARIANT[n]] != got[n] or got[f"{n}_ffma_plans"]:
            raise AssertionError(f"{path}: {n} launched {by} (plan's ffma "
                                 f"shapes {got[f'{n}_ffma_plans']}), not "
                                 f"all {mf.DEFAULT_VARIANT[n]!r}")
    log(f"  {path}: M1 maxsim_dense launches {dense} "
        f"{got['maxsim_dense_by_variant']} ({got['exact_calls']} "
        f"exact-engine calls + {tail_tiles} exact tail tiles), M2 "
        f"maxsim_pairs {pairs} {got['maxsim_pairs_by_variant']} ({sel} "
        f"screened selects)")


@contextlib.contextmanager
def plain_maxsim():
    """The MaxSim engines as they ran before M1 and M2: the plain versions
    of both (the library product and the gather, op by op) and the tile
    step's stable sort, for timings in turns on the card."""
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    from neighborhoodwatch_tpu_torch.ops.topk import smallest_k
    saved = mf.maxsim_dense, mf.maxsim_pairs, M._smallest_k
    mf.maxsim_dense, mf.maxsim_pairs = (mf.maxsim_dense_plain,
                                        mf.maxsim_pairs_plain)
    M._smallest_k = smallest_k
    try:
        yield
    finally:
        mf.maxsim_dense, mf.maxsim_pairs, M._smallest_k = saved


def plain_and_kernel_ms(fn, timer=None):
    """{"plain": ms, "kernel": ms} of `fn` on the plain MaxSim engines and
    on M1 / M2, in turns (plain, kernel, kernel, plain), each a median of
    3 by `timer` (median_ms: host clock around synchronized calls)."""
    timer = timer or median_ms
    got = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        with plain_maxsim() if name == "plain" else contextlib.nullcontext():
            fn()
            got[name].append(timer(fn))
    return {n: float(np.mean(v)) for n, v in got.items()}


# the encoders' fused kernels (ops/encoder_fused.py): E1, E2, E3
ENCODER_KERNELS = ("embed_layernorm", "add_layernorm", "masked_softmax")
# their launches on each path that runs them, counted from 0 just before
# the path and read just after: {path: {kernel: launches}}; per variant
# ({path: {kernel: {variant: launches}}}) and the shapes the plan sent to
# "rowpass" ({path: {kernel: {shape: reason}}})
ENCODER_LAUNCHES = {}
ENCODER_VARIANTS = {}
ENCODER_ROWPASS = {}
# an ATen kernel of the chains E1-E3 replace, by its name in a trace
ATEN_NORM_SOFTMAX = re.compile(r"(?i)softmax|layer_?norm")


@contextlib.contextmanager
def encoder_counted(path):
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    ef.reset_launches()
    yield
    ENCODER_LAUNCHES[path] = {n: getattr(ef, n).launches
                              for n in ENCODER_KERNELS}
    ENCODER_VARIANTS[path] = {n: dict(getattr(ef, n).launches_by_variant)
                              for n in ENCODER_KERNELS}
    ENCODER_ROWPASS[path] = {n: {str(k): v for k, v in
                                 getattr(ef, n).rowpass_plans.items()}
                             for n in ENCODER_KERNELS}


def require_default_variant(path):
    """Fail unless every E1-E3 launch of `path` went to its kernel's
    default variant (encoder_fused.DEFAULT_VARIANT: nothing on the main
    path forces one), or to "rowpass" where the launch plan sent a
    "staged" shape there (counted, with the shapes and reasons logged),
    and none ran the plain chain."""
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    by, plans = ENCODER_VARIANTS[path], ENCODER_ROWPASS[path]
    for name in ENCODER_KERNELS:
        v, default = by[name], ef.DEFAULT_VARIANT[name]
        other = "rowpass" if default == "staged" else "staged"
        if v["plain"] or v[other] and not (other == "rowpass"
                                           and plans[name]):
            raise AssertionError(f"{path}: {name} launched {v}, not its "
                                 f"default {default!r} alone")
    log(f"  {path}'s E2 / E3 launches by variant: add_layernorm "
        f"{by['add_layernorm']}, masked_softmax {by['masked_softmax']}; "
        f"shapes the plan sent to 'rowpass': "
        f"{ {n: p for n, p in plans.items() if p} or 'none'}")


def per_forward(layers, e3=True):
    """E1-E3's launches in one BERT forward of `layers` layers: E3 is 0
    where K6 runs ("flash")."""
    return {"embed_layernorm": 1, "add_layernorm": 2 * layers,
            "masked_softmax": layers if e3 else 0}


def require_encoder(path, forwards, layers):
    """Fail unless every forward of `path` launched E1 once, E2 twice a
    layer and E3 once a layer. `forwards` is graph_forwards()' record: the
    replays, and per capture the WARMUP forwards that ran on the card (a
    capture's own launches are counted at each replay)."""
    from neighborhoodwatch_tpu_torch.models import graphed
    n = forwards["forwards"] + graphed.WARMUP * forwards["captures"]
    want = {k: v * n for k, v in per_forward(layers).items()}
    got = ENCODER_LAUNCHES[path]
    if got != want:
        raise AssertionError(f"{path}: E1-E3 launched {got}, expected "
                             f"{want} ({n} forwards of {layers} layers)")
    log(f"  {path}'s encoder fused kernel launches {got}: E1 1, E2 "
        f"{2 * layers}, E3 {layers} a forward over {n} forwards "
        f"({forwards['forwards']} replays + {graphed.WARMUP} x "
        f"{forwards['captures']} warm-up)")


def require_no_aten_norm(tr, what):
    """Fail unless a trace_share() record of an encoder loop holds E1-E3's
    kernels and no ATen softmax or layer_norm kernel."""
    if tr["idle_share"] == "not measured":
        raise AssertionError(f"{what}: no trace to read the kernels from")
    # (a window's edge may cut a forward's first kernel: E1 is asked for
    # in the window, not in every forward)
    if tr["aten_norm_softmax_kernels"] or \
            not tr["fused_kernels_per_forward"]["embed_layernorm"]:
        raise AssertionError(f"{what}: ATen kernels "
                             f"{tr['aten_norm_softmax_kernels']} left, E1-E3 "
                             f"a forward {tr['fused_kernels_per_forward']}")


def reset_counts(wrapper):
    """Set a kernel wrapper's launch counts to 0, in all and per variant."""
    wrapper.launches = 0
    if hasattr(wrapper, "launches_by_variant"):
        wrapper.launches_by_variant = {
            v: 0 for v in wrapper.launches_by_variant}


# the verified select's launches on each path that runs it, by path, in
# all and per variant: the counts are set to 0 just before the path and
# read just after
VERIFIED_LAUNCHES = {}
VERIFIED_BY_VARIANT = {}


@contextlib.contextmanager
def verified_counted(path):
    from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
    reset_counts(vk.verified_select)
    yield
    VERIFIED_LAUNCHES[path] = vk.verified_select.launches
    VERIFIED_BY_VARIANT[path] = dict(vk.verified_select.launches_by_variant)


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
    from concurrent.futures import ThreadPoolExecutor
    from neighborhoodwatch_tpu_torch.utils import cuda_build
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
    # one nvcc per source, all started together
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    names = ("screen_keys", "maxsim_keys", "masked_attention",
             "verified_select") + FUSED_KERNELS + ENCODER_KERNELS \
        + MAXSIM_KERNELS + ("decoder_passes",)
    t = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        reports = [r for _, r in pool.map(cuda_build.build, names)]
    sk.load_library()
    mk.load_library()
    ak.load_library()
    vk.load_library()
    fc.load_libraries()
    ef.load_libraries()
    mf.load_libraries()
    log(f"kernel builds ({', '.join(names)}): "
        f"{time.perf_counter() - t:.2f} s "
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, report in zip(names, reports):
        ptxas_report(name, report)
    return card


def phase_kernel_vs_plain():
    import torch
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    g = torch.Generator(device="cuda").manual_seed(1)
    # D=200 (not a multiple of 64; B ends inside a 256-row step): TMA's
    # zero fill; D=45: "mma" with scalar loads; 1,078 queries: 17 query
    # blocks, so the cluster of 2 leaves one surplus block per mega
    cases = [(70, 2 * sk.MEGA + 555, 200, sk.TB * sk.SUB_PER_MEGA),
             (50, sk.MEGA + 77, 45, sk.TB * sk.SUB_PER_MEGA),
             (1078, sk.MEGA + 300, 72, sk.TB * sk.SUB_PER_MEGA),
             (33, sk._BIG_BASE + 4099, 200, sk.TB * 112)]
    worst = 0.0
    for qn_, bn_, d, mega in cases:
        q = torch.randn(qn_, d, device="cuda", generator=g)
        b = torch.randn(bn_, d, device="cuda", generator=g)
        ops = screen_operands(q, b)
        chosen = sk.pick_variant(d, True)
        for passes in (1, 2, 3):
            for epi in sk.EPILOGUES:
                kp = sk.screen_keys_plain(**ops, mega_rows=mega,
                                          passes=passes, epilogue=epi)
                for variant in dict.fromkeys((chosen, "mma")):
                    with sk.forced_variant(variant):
                        k = sk.screen_keys(**ops, mega_rows=mega,
                                           passes=passes, epilogue=epi)
                    torch.cuda.synchronize()
                    err, swapped = compare_keys(k, kp, epi, mega, q, b)
                    worst = max(worst, err)
                    log(f"  Q={qn_} B={bn_} D={d} mega={mega} "
                        f"passes={passes} {epi} [{variant}]: max |d_kernel "
                        f"- d_plain| {err:.3g}, swapped ids (within "
                        f"tolerance) {swapped}")
        del q, b, ops
    torch.cuda.empty_cache()
    return worst


def unit_rows(n, D, gen, chunk=100_000):
    """(n, D) unit-norm Gaussian rows from `gen`, on the card."""
    import torch
    out = torch.empty(n, D, device="cuda")
    for s in range(0, n, chunk):
        x = torch.randn(min(chunk, n - s), D, device="cuda", generator=gen)
        out[s:s + len(x)] = x / x.norm(dim=1, keepdim=True)
        del x
    return out


def engine_data(Q=10_000, B=1_000_000, D=1536, seed=2):
    """Phase 3's queries and base, made anew from the same seed."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(Q, D, device="cuda", generator=g)
    q /= q.norm(dim=1, keepdim=True)
    return q, unit_rows(B, D, g)


def phase_engine(rec):
    """Returns phase 3's knn(auto) result and its seconds for phase 11."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    Q, B, D, k = 10_000, 1_000_000, 1536, 100
    q, base = engine_data(Q, B, D)
    engine = K._select_engine("auto", B, q.device)
    if engine != "screened":
        raise AssertionError(f"auto picked {engine!r}, not 'screened'")

    # ---- the main-path call, counted ----
    reset_counts(sk.screen_keys)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with fused_counted("knn_auto"), verified_counted("knn_auto"):
        d_s, i_s = K.knn(q, base, k, engine="auto")
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = sk.screen_keys.launches
    by_variant = dict(sk.screen_keys.launches_by_variant)
    if launches < 1:
        raise AssertionError("knn(engine='auto') never launched the kernel")
    if by_variant["mma"] or by_variant["wgmma"] != launches:
        raise AssertionError(f"knn(auto) launched {by_variant}: every launch "
                             f"at these shapes must take 'wgmma'")
    # F1 prepares the base, F3 re-ranks, K7 takes the merge's top-m
    require_fused("knn_auto", ("prepare_base", "rerank_rows"))
    if VERIFIED_LAUNCHES["knn_auto"] < 1:
        raise AssertionError("knn(auto)'s merge never launched K7")
    log(f"  knn(auto) -> engine {engine}, kernel launches {launches} "
        f"{by_variant}, fused kernels {FUSED_LAUNCHES['knn_auto']} (F3 by "
        f"variant, and the shapes its plan sent to rowwise), K7 "
        f"{VERIFIED_LAUNCHES['knn_auto']}, first call {first_s:.3f} s")

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
    kernel, before = {}, {}
    blo = (base - prep.bhi.float()).to(torch.bfloat16)
    for passes in (1, 2, 3):
        def run(p=passes):
            return sk.screen_keys(qhi, qlo, prep.bhi, blo if p == 3 else None,
                                  qn, bn, mega, p, "l2")
        before[passes], kernel[passes] = turns_ms(sk, run)
        flops = 2.0 * Q * B * D * passes
        bound = flops / PEAK_BF16_FLOPS * 1e3
        log(f"  screen kernel {passes}-pass (l2, sub={sub}), variants in "
            f"turns: mma {before[passes]:.1f} ms "
            f"({flops / before[passes] / 1e9:.1f} TFLOP/s, "
            f"{before[passes] / bound:.2f}x bound), wgmma "
            f"{kernel[passes]:.1f} ms ({flops / kernel[passes] / 1e9:.1f} "
            f"TFLOP/s, {kernel[passes] / bound:.2f}x bound); bound "
            f"{bound:.1f} ms; default "
            f"'{sk.pick_variant(D, True)}'")
    sweep = {p: cluster_sweep_ms(sk, lambda p=p: sk.screen_keys(
        qhi, qlo, prep.bhi, blo if p == 3 else None, qn, bn, mega, p, "l2"))
        for p in (1, 2, 3)}
    log("  wgmma variant by blocks per cluster (1 / 2 / 4), ms: " + "; ".join(
        f"{p}-pass {sweep[p][1]:.1f} / {sweep[p][2]:.1f} / {sweep[p][4]:.1f}"
        for p in sweep))
    rec["cluster_sweep_ms"] = {str(p): sweep[p] for p in sweep}
    # the streamed batch's shape (phase 4): 1,000 queries, one 100,000-row
    # batch, sub=28: 16 query blocks x 4 megas = 64 blocks on 132 SMs
    sQ, sB, smega = 1000, 100_000, sk.TB * sk.SUB_PER_MEGA
    s_ops = [t[:sQ].contiguous() for t in (qhi, qlo, qn)]
    streamed = {}
    for passes in (1, 2, 3):
        def run_s(p=passes):
            return sk.screen_keys(s_ops[0], s_ops[1], prep.bhi[:sB],
                                  blo[:sB] if p == 3 else None, s_ops[2],
                                  bn[:sB], smega, p, "l2")
        o_ms, n_ms = turns_ms(sk, run_s)

        def products_s(p=passes):
            torch.mm(s_ops[0], prep.bhi[:sB].T)
            if p >= 2:
                torch.mm(s_ops[1], prep.bhi[:sB].T)
            if p == 3:
                torch.mm(s_ops[0], blo[:sB].T)
        l_ms = event_ms(products_s)
        bound = 2.0 * sQ * sB * D * passes / PEAK_BF16_FLOPS * 1e3
        streamed[str(passes)] = {"ms": n_ms, "ms_before": o_ms,
                                 "bound_ms": bound, "library_ms": l_ms}
        log(f"  streamed-batch shape {sQ} x {sB} x {D}, sub=28, {passes}-pass:"
            f" mma {o_ms:.2f} ms, wgmma {n_ms:.2f} ms, bound {bound:.2f} ms,"
            f" torch.mm of the {passes} products {l_ms:.2f} ms")
    rec["streamed_batch_shape"] = streamed
    del blo, s_ops
    torch.cuda.empty_cache()
    keys = sk.screen_keys(qhi, qlo, prep.bhi, None, qn, bn, mega, 1, "l2")
    torch.cuda.synchronize()
    t = time.perf_counter()
    keys_plain = sk.screen_keys_plain(qhi, qlo, prep.bhi, None, qn, bn, mega,
                                      1, "l2")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err, swapped = compare_keys(keys, keys_plain, "l2", mega, q, base)
    log(f"  plain version at the same shapes: {plain_ms:.1f} ms; kernel "
        f"[{sk.pick_variant(D, True)}] vs plain max |d| {err:.3g}, "
        f"swapped ids (within tolerance) {swapped}")
    with sk.forced_variant("mma"):
        keys = sk.screen_keys(qhi, qlo, prep.bhi, None, qn, bn, mega, 1, "l2")
    e_m, sw_m = compare_keys(keys, keys_plain, "l2", mega, q, base)
    log(f"  kernel [mma] vs plain max |d| {e_m:.3g}, swapped ids (within "
        f"tolerance) {sw_m}")
    del keys, keys_plain
    torch.cuda.empty_cache()
    library_ms = event_ms(lambda: torch.mm(qhi, prep.bhi.T), runs=3)
    torch.cuda.empty_cache()
    log(f"  library yardstick torch.mm(bf16 q, bf16 base^T): "
        f"{library_ms:.1f} ms")

    # the 2- and 3-pass tiers (the TPU's wide/pipelined schedule): plain
    # version and the torch.mm of the same 2 or 3 bf16 products
    by_passes = {}
    blo = (base - prep.bhi.float()).to(torch.bfloat16)
    for passes in (2, 3):
        bl = blo if passes == 3 else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        kp = sk.screen_keys_plain(qhi, qlo, prep.bhi, bl, qn, bn, mega,
                                  passes, "l2")
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t) * 1e3
        kk = sk.screen_keys(qhi, qlo, prep.bhi, bl, qn, bn, mega, passes,
                            "l2")
        e, sw = compare_keys(kk, kp, "l2", mega, q, base)
        with sk.forced_variant("mma"):
            kk = sk.screen_keys(qhi, qlo, prep.bhi, bl, qn, bn, mega, passes,
                                "l2")
        e_m, sw_m = compare_keys(kk, kp, "l2", mega, q, base)
        del kk, kp
        torch.cuda.empty_cache()

        def products(p=passes):
            torch.mm(qhi, prep.bhi.T)
            torch.mm(qlo, prep.bhi.T)
            if p == 3:
                torch.mm(qhi, blo.T)
        l_ms = event_ms(products)
        torch.cuda.empty_cache()
        by_passes[str(passes)] = {
            "ms": kernel[passes], "ms_before": before[passes],
            "variant": sk.pick_variant(D, True),
            "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": 2.0 * Q * B * D * passes / PEAK_BF16_FLOPS * 1e3,
            "max_abs_err": e}
        log(f"  {passes}-pass: plain {p_ms:.1f} ms, torch.mm of the "
            f"{passes} bf16 products {l_ms:.1f} ms; kernel "
            f"[{sk.pick_variant(D, True)}] vs plain max |d| {e:.3g},"
            f" swapped ids (within tolerance) {sw}; [mma] {e_m:.3g}, {sw_m}")
    del blo
    rec["by_passes"] = by_passes

    n_mega = -(-B // mega)
    bytes_ = Q * D * 2 + B * D * 2 + Q * 4 + B * 4 + Q * n_mega * 512 * 4
    flops = 2.0 * Q * B * D
    bound_ms = max(bytes_ / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    rec.update(launches=launches, launches_by_variant=by_variant,
               variant=sk.pick_variant(D, True), max_abs_err=err,
               ms=kernel[1], ms_before=before[1],
               plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="operations" if flops / PEAK_BF16_FLOPS
               >= bytes_ / PEAK_BYTES else "bytes", library_ms=library_ms)
    log(f"  bound (1 pass): {bound_ms:.1f} ms ({rec['bound_by']})")
    result = {"d": d_s.cpu(), "i": i_s.cpu(), "first_s": first_s,
              "median_ms": screened_ms}
    del q, base, prep, d_s, i_s, d_e, i_e
    torch.cuda.empty_cache()
    return result


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
    reset_counts(sk.screen_keys)
    # CUDA events around each kernel launch of the pipeline
    lib = sk.load_library()
    real_launch, events = lib.screen_keys_launch, []

    def timed_launch(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        err = real_launch(*args)
        e1.record()
        events.append((e0, e1))
        return err
    lib.screen_keys_launch = timed_launch
    t = time.perf_counter()
    try:
        with verified_counted("pipeline"):
            timer = compute_knn_ds(data_dir, D, qfile, Q, bfile, B, k=k,
                                   initial_batch_size=100_000)
    finally:
        lib.screen_keys_launch = real_launch
    torch.cuda.synchronize()
    launch_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    files = generate_output_files(
        data_dir, model, D, bfile, qfile, B, Q,
        naming.get_partial_indices_filename(data_dir, -1),
        naming.get_partial_distances_filename(data_dir, -1), k,
        output_hdf5=output_hdf5)
    mismatches = validate_files_v0(data_dir, *files)
    wall = time.perf_counter() - t
    launches = sk.screen_keys.launches
    by_variant = dict(sk.screen_keys.launches_by_variant)
    log(f"  compute_knn_ds + export + validate: {wall:.1f} s "
        f"(stages {timer.to_json()}), kernel launches {launches} "
        f"{by_variant}, kernel ms per launch (CUDA events) "
        f"{[round(x, 2) for x in launch_ms]}, "
        f"validate_files_v0 mismatches {mismatches}")
    if launches < 1:
        raise AssertionError("the streamed pipeline never launched the kernel")
    if by_variant["mma"] or by_variant["wgmma"] != launches:
        raise AssertionError(f"the pipeline launched {by_variant}: every "
                             f"launch at these shapes must take 'wgmma'")
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
    rec["pipeline_launches"] = launches
    rec["pipeline_launches_by_variant"] = by_variant
    rec["pipeline_kernel_ms"] = launch_ms
    return {"data_dir": data_dir, "qfile": qfile, "bfile": bfile,
            "files": files, "shape": (Q, B, D, k),
            "stages": dict(timer.stages)}


def unit_tokens(n, t, dim, gen, chunk=20_000):
    """(n, t, dim) unit-norm Gaussian tokens from `gen`, on the card."""
    import torch
    out = torch.empty((n, t, dim), device="cuda")
    for s in range(0, n, chunk):
        x = torch.randn((min(chunk, n - s), t, dim), device="cuda",
                        generator=gen)
        out[s:s + len(x)] = x / x.norm(dim=2, keepdim=True)
    return out


def phase_maxsim_kernel_vs_plain():
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    g = torch.Generator(device="cuda").manual_seed(5)

    def case(Q, Tq, D, Td, dim):
        q = torch.randn((Q, Tq, dim), device="cuda", generator=g)
        d = torch.randn((D, Td, dim), device="cuda", generator=g)
        qm = torch.rand((Q, Tq), device="cuda", generator=g) < 0.8
        qm[:, 0] = True
        qm[0, 1:] = False                      # one single-token query
        dm = torch.rand((D, Td), device="cuda", generator=g) < 0.7
        dm[:, 0] = True
        dm[5] = False                          # empty docs
        dm[D - 1] = False
        d[9, Td // 2] = float("nan")           # one NaN doc
        dm[9, Td // 2] = True
        return q, qm, d, dm

    worst, n_cases, swapped_all = 0.0, 0, 0
    shapes = [(19, tq, 1500, td, dim) for tq in (7, 24, 32)
              for td in (12, 24, 64, 180) for dim in (128, 32, 256)]
    shapes.append((37, 32, 3 * mk.MEGA_DOCS + 77, 12, 128))
    # dim 64: one 64-column chunk; 37 queries of 24 tokens: 10 blocks of 4
    # queries, the last one ragged; 19 of 7: 2 blocks, a whole cluster
    shapes.append((37, 24, mk.MEGA_DOCS + 300, 16, 64))
    for Q, Tq, D, Td, dim in shapes:
        q, qm, d, dm = case(Q, Tq, D, Td, dim)
        chosen = mk.pick_variant(-(-dim // 16) * 16)
        variants = tuple(dict.fromkeys((chosen, "mma")))
        for passes in (1, 2, 3):
            ops = mk.prepare_operands(q, qm, d, dm, passes)[:5]
            plain = mk.maxsim_keys_plain(*ops, passes)
            for variant in variants:
                with mk.forced_variant(variant):
                    keys = mk.maxsim_keys(*ops, passes)
                torch.cuda.synchronize()
                err, swapped = mk.candidates_agree(
                    mk.decode_keys(keys), mk.decode_keys(plain), q, qm, d,
                    dm)
                worst = max(worst, err)
                swapped_all += swapped
                n_cases += 1
        log(f"  Q={Q} Tq={Tq} D={D} Td={Td} dim={dim} passes 1/2/3 on "
            f"{' and '.join(variants)}: ok")
        del q, qm, d, dm, ops, keys, plain
    torch.cuda.empty_cache()
    log(f"  {n_cases} cases: max |score_kernel - score_plain| {worst:.3g}, "
        f"swapped ids (within tolerance) {swapped_all}")
    return worst


def check_against_exact(s_a, i_a, s_e, i_e, k, what):
    """Result `a` against the exact engine's: recall 1.0, and positions
    different only between docs whose scores tie within 1e-3."""
    import torch
    a, e = i_a.cpu().numpy(), i_e.cpu().numpy()
    recall = float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, e)]))
    same = float((a == e).mean())
    dd = (s_a - s_e).abs()
    ties_ok = bool((torch.from_numpy(a != e).to(dd.device)
                    <= (dd <= 1e-3)).all())
    log(f"  {what}: recall {recall:.4f}, identical positions {same:.5f}, "
        f"max |score - exact| {float(dd.max()):.3g}")
    if recall != 1.0 or not ties_ok or float(dd.max()) > 1e-3:
        raise AssertionError(f"{what} differs from the exact engine")


def oracle_topk_check(q, qm, d, dm, s_a, i_a, k, what, n=16):
    """An engine's top-k of the first `n` query passages against float64
    MaxSim over every doc (a NaN score as -inf, as the engines rank it):
    each returned score within 1e-3 of its doc's float64 score, and none
    worse than the float64 k-th score by more than 1e-3 (tie-tolerant)."""
    import torch
    qd = q[:n].double()
    rows = []
    for s in range(0, d.shape[0], 16_384):
        dd = d[s:s + 16_384].double()
        sims = torch.einsum("qtk,dsk->qtds", qd, dd)
        sims = torch.where(dm[s:s + 16_384][None, None], sims, -1e30)
        tok = sims.amax(3)
        rows.append(torch.where(qm[:n, :, None], tok, 0.0).sum(1))
    exact = torch.cat(rows, 1).nan_to_num(nan=-float("inf"))
    kth = exact.topk(k, dim=1).values[:, k - 1:k]
    ids = i_a[:n].long().to(exact.device)
    at = exact.gather(1, ids)
    err = float((at - s_a[:n].double().to(exact.device)).abs().max())
    short = float((kth - at).max())
    log(f"  {what} against float64 MaxSim on {n} queries: max |score - "
        f"float64| {err:.3g}, worst shortfall against the float64 k-th "
        f"score {short:.3g}")
    if err > 1e-3 or short > 1e-3:
        raise AssertionError(f"{what} differs from float64 MaxSim")


def maxsim_stages(q, qm, d, dm, k, diagnostics=False):
    """The stages of one 3-pass maxsim_topk_screened call, run one by one
    (medians of 3; the kernel by CUDA events). Returns (prep_ms, kernel_ms,
    select_ms, operands, keys); `diagnostics` runs prep and select as the
    adaptive stream does (residual statistic, tier probe)."""
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    prep_ms = median_ms(lambda: mk.prepare_operands(q, qm, d, dm, 3,
                                                    diagnostics))
    ops = mk.prepare_operands(q, qm, d, dm, 3, diagnostics)
    kernel_ms = event_ms(lambda: mk.maxsim_keys(*ops[:5], 3))
    keys = mk.maxsim_keys(*ops[:5], 3)
    cn, cd = mk.decode_keys(keys)
    m, block, _ = M.maxsim_screen_plan(d.shape[0], k, d.shape[1], d.shape[2],
                                       passes=3)
    select_ms = median_ms(lambda: M._maxsim_select(
        q, qm, d, dm, cn, cd, k, m, block=block, passes=3, doc_stats=ops[5],
        with_diagnostics=diagnostics))
    return prep_ms, kernel_ms, select_ms, ops, keys


def product_loop_ms(ops3, passes):
    """Product-only yardstick, measured whole (CUDA events, median of 3):
    torch.mm of the kernel's own bf16 operands, one 8192-doc tile at a
    time with the ragged last tile, the 1, 2 or 3 products of the tier
    (qhi.dhi [+ qlo.dhi [+ qhi.dlo]]). No max, sum or selection."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    qhi, qlo, dhi, dlo = ops3[:4]
    dimp = qhi.shape[2]
    qh2, ql2 = qhi.reshape(-1, dimp), qlo.reshape(-1, dimp)

    def run():
        for s in range(0, dhi.shape[0], mk.MEGA_DOCS):
            th = dhi[s:s + mk.MEGA_DOCS].reshape(-1, dimp).T
            torch.mm(qh2, th)
            if passes >= 2:
                torch.mm(ql2, th)
            if passes >= 3:
                torch.mm(qh2, dlo[s:s + mk.MEGA_DOCS].reshape(-1, dimp).T)
    ms = event_ms(run)
    torch.cuda.empty_cache()
    return ms


def phase_maxsim_engine(rec):
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    Q, Tq, dim, k = 1000, 32, 128, 100
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = unit_tokens(Q, Tq, dim, gen)
    qm = torch.ones((Q, Tq), dtype=torch.bool, device="cuda")
    shapes = {}
    for label, (D, Td) in (("200k x 16", (200_000, 16)),
                           ("50k x 64", (50_000, 64))):
        d = unit_tokens(D, Td, dim, gen)
        dm = torch.ones((D, Td), dtype=torch.bool, device="cuda")
        engine = M._maxsim_engine("auto", D, Tq, dim, q.device)
        if engine != "screened":
            raise AssertionError(f"auto picked {engine!r}, not 'screened'")

        # ---- the main-path call, counted ----
        reset_counts(mk.maxsim_keys)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with maxsim_counted(f"one-shot {label}"):
            s_s, i_s = M.maxsim_topk(q, qm, d, dm, k, engine="auto")
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        require_maxsim(f"one-shot {label}")
        launches = mk.maxsim_keys.launches
        by_variant = dict(mk.maxsim_keys.launches_by_variant)
        if launches < 1:
            raise AssertionError("maxsim_topk(auto) never launched the "
                                 "kernel")
        if by_variant["mma"] or by_variant["wgmma"] != launches:
            raise AssertionError(f"maxsim_topk(auto) launched {by_variant}: "
                                 f"dim 128 must take 'wgmma'")
        log(f"  [{label}] maxsim_topk(auto) -> engine {engine}, kernel "
            f"launches {launches} {by_variant}, first call {first_s:.3f} s")
        M.counts.repaired = 0
        M.counts.exact_fallbacks = 0
        call_ms = median_ms(lambda: M.maxsim_topk(q, qm, d, dm, k,
                                                  engine="auto"))
        log(f"  [{label}] call median of 3: {call_ms:.1f} ms; per call "
            f"class-A bin repairs {M.counts.repaired // 3}, exact "
            f"fallbacks {M.counts.exact_fallbacks // 3}")

        n_chk = 64
        with maxsim_counted(f"exact {label}"):
            s_e, i_e = M.maxsim_topk(q[:n_chk], qm[:n_chk], d, dm, k,
                                     engine="exact", tile_docs=2048)
        require_maxsim(f"exact {label}")
        exact = plain_and_kernel_ms(
            lambda: M.maxsim_topk(q[:n_chk], qm[:n_chk], d, dm, k,
                                  engine="exact", tile_docs=2048),
            lambda f: median_ms(f, runs=1))
        exact_ms = exact["kernel"]
        log(f"  [{label}] exact engine on {n_chk} queries: {exact_ms:.1f} ms "
            f"on M1 and K7, {exact['plain']:.1f} ms on the plain versions "
            f"(in turns)")
        check_against_exact(s_s[:n_chk], i_s[:n_chk], s_e, i_e, k,
                            f"[{label}] screened vs exact")
        oracle_topk_check(q, qm, d, dm, s_s, i_s, k,
                          f"[{label}] maxsim_topk(auto)")
        oracle_topk_check(q, qm, d, dm, s_e, i_e, k,
                          f"[{label}] exact engine")

        # ---- stages of the call (3-pass tier), run one by one ----
        prep_ms, _, select_ms, ops3, keys = maxsim_stages(q, qm, d, dm, k)

        # ---- the kernel at the main path's shapes ----
        kernel, before = {}, {}
        for passes in (1, 2, 3):
            ops = ops3[:5] if passes == 3 else \
                mk.prepare_operands(q, qm, d, dm, passes)[:5]
            before[passes], kernel[passes] = turns_ms(
                mk, lambda o=ops, p=passes: mk.maxsim_keys(*o, p))
            flops = 2.0 * Q * Tq * D * Td * dim * passes
            bound = flops / PEAK_BF16_FLOPS * 1e3
            log(f"  [{label}] maxsim kernel {passes}-pass, variants in "
                f"turns: mma {before[passes]:.1f} ms "
                f"({flops / before[passes] / 1e9:.1f} TFLOP/s, "
                f"{before[passes] / bound:.2f}x bound), wgmma "
                f"{kernel[passes]:.1f} ms "
                f"({flops / kernel[passes] / 1e9:.1f} TFLOP/s, "
                f"{kernel[passes] / bound:.2f}x bound); bound {bound:.1f} ms;"
                f" default '{mk.pick_variant(dim)}'")
            del ops
        if label == "200k x 16":
            sweep = cluster_sweep_ms(
                mk, lambda: mk.maxsim_keys(*ops3[:5], 3))
            log(f"  [{label}] wgmma variant, 3 passes, by blocks per cluster "
                f"(1 / 2 / 4): {sweep[1]:.1f} / {sweep[2]:.1f} / "
                f"{sweep[4]:.1f} ms")
        log(f"  [{label}] stages of a 3-pass call: prep {prep_ms:.1f} ms, "
            f"kernel {kernel[3]:.1f} ms, decode + select (merge, re-rank, "
            f"certificate, repair) {select_ms:.1f} ms, the rest "
            f"{call_ms - prep_ms - kernel[3] - select_ms:.1f} ms")
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = mk.maxsim_keys_plain(*ops3[:5], 3)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err, swapped = mk.candidates_agree(
            mk.decode_keys(keys), mk.decode_keys(plain), q, qm, d, dm)
        log(f"  [{label}] plain version (3 passes): {plain_ms:.1f} ms; "
            f"kernel [{mk.pick_variant(dim)}] vs plain max |score| "
            f"{err:.3g}, swapped ids (within tolerance) {swapped}")
        with mk.forced_variant("mma"):
            keys = mk.maxsim_keys(*ops3[:5], 3)
        e_m, sw_m = mk.candidates_agree(
            mk.decode_keys(keys), mk.decode_keys(plain), q, qm, d, dm)
        log(f"  [{label}] kernel [mma] vs plain max |score| {e_m:.3g}, "
            f"swapped ids (within tolerance) {sw_m}")
        del plain, keys
        # product-only yardstick: no single PyTorch call computes MaxSim
        mm_ms = {p: product_loop_ms(ops3, p) for p in (1, 2, 3)}
        log(f"  [{label}] product-only yardstick, measured whole: torch.mm "
            f"of the bf16 operands over {-(-D // mk.MEGA_DOCS)} 8192-doc "
            f"tiles (ragged last tile), the tier's 1 / 2 / 3 products: "
            f"{mm_ms[1]:.1f} / {mm_ms[2]:.1f} / {mm_ms[3]:.1f} ms (no max, "
            f"sum or selection)")
        del ops3
        torch.cuda.empty_cache()

        n_mega = -(-D // mk.MEGA_DOCS)
        bytes_ = (Q * Tq * dim * 2 * 2 + D * Td * dim * 2 * 2 + D * 4
                  + Q * n_mega * 512 * 4)
        flops = 2.0 * Q * Tq * D * Td * dim * 3
        bound_ms = max(bytes_ / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
        shapes[label] = {
            "launches": launches, "launches_by_variant": by_variant,
            "max_abs_err": err, "ms": kernel[3], "ms_before": before[3],
            "ms_by_passes": {str(p): kernel[p] for p in kernel},
            "ms_before_by_passes": {str(p): before[p] for p in before},
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16_FLOPS
            >= bytes_ / PEAK_BYTES else "bytes",
            "product_yardstick_ms": mm_ms[3],
            "product_yardstick_ms_by_passes": {str(p): mm_ms[p]
                                               for p in mm_ms},
            "call_ms": call_ms, "exact_ms": exact_ms,
            "exact_plain_ms": exact["plain"],
            "select_ms": select_ms}
        if label == "200k x 16":
            stream, stream_result = stream_maxsim(q, qm, d, dm, k, s_s,
                                                  i_s)
        del d, dm, s_s, i_s, s_e, i_e
        torch.cuda.empty_cache()

    main = shapes["200k x 16"]
    rec.update({key: main[key] for key in
                ("max_abs_err", "ms", "ms_before", "plain_ms", "bound_ms",
                 "bound_by", "product_yardstick_ms")})
    rec["library_ms"] = None
    rec["passes"] = 3
    rec["variant"] = mk.pick_variant(dim)
    # launches are kept per path, never summed: the one-shot calls' stand
    # in `shapes`, the stream's here, ck's (the record's `launches`) in
    # phase 7
    rec.update(stream)
    rec["shapes"] = shapes
    return stream_result


def stream_maxsim(q, qm, d, dm, k, s_one, i_one):
    """StreamingMaxSim("auto") over `d` in 8192-doc tiles; returns its
    kernel launches and the share of (query, screened tile) pairs that the
    exact engine recomputed after a failed certificate, and the stream's
    result and seconds (for phase 11)."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    D = d.shape[0]
    tile = mk.MEGA_DOCS
    n_tiles = -(-D // tile)
    n_full = sum(1 for s in range(0, D, tile)
                 if min(tile, D - s) >= M.SCREEN_MIN_DOCS)
    reset_counts(mk.maxsim_keys)
    M.counts.host_copies = 0
    M.counts.escalated = 0
    M.counts.exact_fallbacks = 0
    M.counts.repaired = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with maxsim_counted("stream"):
        acc = M.StreamingMaxSim(q, qm, k, screen_precision="auto")
        for s in range(0, D, tile):
            acc.update(d[s:s + tile], dm[s:s + tile])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = mk.maxsim_keys.launches
    share = M.counts.exact_fallbacks / (q.shape[0] * max(n_full, 1))
    log(f"  [stream] {n_tiles} tiles of {tile} docs ({n_full} screened, "
        f"{n_tiles - n_full} exact tail): {wall * 1e3:.1f} ms, "
        f"{wall * 1e3 / n_tiles:.1f} ms per tile; kernel launches "
        f"{launches}, queries escalated {M.counts.escalated}, "
        f"repaired from their bins {M.counts.repaired}, sent to "
        f"the exact engine {M.counts.exact_fallbacks} of "
        f"{q.shape[0]} x {n_full} (share {share:.4f}: the kernel's keys "
        f"decide the rest), final tier "
        f"'{M.MAXSIM_TIER_LADDER[acc._tier_idx]}', host copies per screened "
        f"tile {M.counts.host_copies / max(n_full, 1):.2f}")
    if launches < n_full:
        raise AssertionError("a full tile did not launch the kernel")
    require_maxsim("stream", tail_tiles=n_tiles - n_full)
    if mk.maxsim_keys.launches_by_variant["mma"]:
        raise AssertionError("the stream launched the 'mma' variant at "
                             "dim 128")
    check_against_exact(acc.state[0], acc.state[1], s_one, i_one, k,
                        "[stream] streamed vs one-shot")
    oracle_topk_check(q, qm, d, dm, acc.state[0], acc.state[1], k,
                      "[stream] StreamingMaxSim")
    result = {"s": acc.state[0].cpu(), "i": acc.state[1].cpu(),
              "seconds": wall}
    # where one streamed tile's time goes (3-pass tier with diagnostics,
    # as the adaptive stream runs it), stages run one by one
    tq, tm = d[:tile], dm[:tile]
    M.counts.exact_fallbacks = 0
    call_ms = median_ms(lambda: M.maxsim_topk_screened(
        q, qm, tq, tm, k, screen_precision="high", with_diagnostics=True))
    n_exact = M.counts.exact_fallbacks // 3
    prep_ms, kern_ms, sel_ms, _, _ = maxsim_stages(q, qm, tq, tm, k,
                                                   diagnostics=True)
    merge_ms = median_ms(lambda: acc.update(tq, tm, offset=acc.docs_seen)) \
        - call_ms
    log(f"  [stream] one 8192-doc tile: call {call_ms:.1f} ms = prep "
        f"{prep_ms:.1f} + kernel {kern_ms:.1f} + decode/select with "
        f"diagnostics {sel_ms:.1f} + the rest "
        f"{call_ms - prep_ms - kern_ms - sel_ms:.1f} (exact engine for the "
        f"{n_exact} queries whose "
        f"certificate failed); update() adds "
        f"{merge_ms:.1f} ms (running top-k merge)")
    # the tile's call and its exact engine alone, on M1 / M2 against the
    # plain versions (the engines as they ran before M1 and M2), in turns
    ops = mk.prepare_operands(q, qm, tq, tm, 3, True)
    cn, cd = mk.decode_keys(mk.maxsim_keys(*ops[:5], 3))
    m, block, _ = M.maxsim_screen_plan(tile, k, d.shape[1], d.shape[2], 3)
    ok = M._maxsim_select(q, qm, tq, tm, cn, cd, k, m, block=block,
                          passes=3, doc_stats=ops[5])[2]
    bad = torch.nonzero(~ok)[:, 0].to(q.device)
    del ops, cn, cd
    turns = plain_and_kernel_ms(lambda: M.maxsim_topk_screened(
        q, qm, tq, tm, k, screen_precision="high", with_diagnostics=True))
    exact = plain_and_kernel_ms(lambda: M._exact_topk(
        q[bad], qm[bad], tq, tm, k, 2048))
    log(f"  [stream] one 8192-doc tile in turns (plain, kernel, kernel, "
        f"plain): call {turns['kernel']:.1f} ms on M1 / M2 / K7, "
        f"{turns['plain']:.1f} ms on the plain versions; its exact engine "
        f"alone for the {len(bad)} failed queries {exact['kernel']:.1f} ms, "
        f"{exact['plain']:.1f} ms plain (share of the call "
        f"{exact['kernel'] / turns['kernel']:.3f}, plain "
        f"{exact['plain'] / turns['plain']:.3f})")
    torch.cuda.empty_cache()
    return {"stream_launches": launches,
            "stream_exact_fallback_share": share,
            "stream_tile": {"call_ms": turns["kernel"],
                            "call_plain_ms": turns["plain"],
                            "exact_ms": exact["kernel"],
                            "exact_plain_ms": exact["plain"],
                            "failed_queries": len(bad),
                            "per_tile_ms": wall * 1e3 / n_tiles}}, result


def phase_ck(rec, workdir):
    import torch
    from neighborhoodwatch_tpu_torch.cli import ck_main
    from neighborhoodwatch_tpu_torch.core.colbert_pipeline import (
        _read_doc_tokens, _split_by_doc,
    )
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.models import graphed
    from neighborhoodwatch_tpu_torch.models.bert import COLBERT_BASE_CONFIG
    from neighborhoodwatch_tpu_torch.models.colbert import (
        ColbertEmbeddingGenerator,
    )
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.validate import validate_maxsim_files
    # a synthetic source row is one 17-token passage: 512 query passages,
    # 17,408 base passages = 2 full 8192-doc tiles + a 1,024-doc tail,
    # which the pipeline pads to 8192 masked rows and screens too
    per_doc, n_q, n_b, k = 17, 512, 17_408, 100
    q_tok, b_tok = per_doc * n_q, per_doc * n_b
    argv = [str(q_tok), str(b_tok), "-k", str(k), "-es", "small",
            "--data-dir", workdir, "--maxsim", "--synthetic",
            "--post-validation", "-y"]
    output_hdf5 = importlib.util.find_spec("h5py") is not None
    if not output_hdf5:
        argv.append("--no-gen-hdf5")
        log("  hdf5 export skipped: h5py is not installed on this machine")
    # (a) measured once: the encoder loop as ck's source loop runs it (one
    # passage a call), op by op, on a generator of ck's configuration
    col = ColbertEmbeddingGenerator(device="cuda")
    calls = [[p] for p in base_texts(512)]
    with graphed.forced_variant("eager"):
        eager = encoder_loop(col, calls, workdir, "ColBERT eager",
                             calls[:256])
    del col
    reset_counts(mk.maxsim_keys)
    M.counts.repaired = M.counts.escalated = M.counts.exact_fallbacks = 0
    tee = Tee(sys.stdout)
    # base passages 489 .. 1,000 of the run (calls 1,001 .. 1,512 after
    # the 512 query passages) traced
    t = time.perf_counter()
    with graph_forwards() as forwards, contextlib.redirect_stdout(tee), \
            encoder_counted("ck"), maxsim_counted("ck"), \
            traced_window(ColbertEmbeddingGenerator, 1001, 512,
                          os.path.join(workdir, "ck_trace")) as window:
        ck_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    require_graphed(forwards, "ck_main")
    require_encoder("ck", forwards, COLBERT_BASE_CONFIG.num_layers)
    require_default_variant("ck")
    sections, tokens = nw_sections(tee.kept.getvalue())
    rates = {name: toks / secs for name, (toks, secs) in tokens.items()
             if secs > 0}
    graph = trace_share(os.path.join(workdir, "ck_trace"),
                        window["forwards"])
    log(f"  ck_main sections (s) {sections}; encoder tokens/s "
        f"{({n: round(r) for n, r in rates.items()})}; base encode, "
        f"{window['forwards']} one-passage forwards traced: graphed "
        f"{share_text(graph)}; eager (a) {share_text(eager)}")
    require_no_aten_norm(eager, "ck's encoder loop (a), op by op")
    require_no_aten_norm(graph, "ck_main's traced base encode")
    rec["ck_encoder"] = {"sections_s": sections,
                         "encoder_tokens_per_s": rates, "eager": eager,
                         "graph_trace": graph, "forwards": forwards,
                         "fused_launches": ENCODER_LAUNCHES["ck"],
                         "fused_launches_by_variant": ENCODER_VARIANTS["ck"],
                         "rowpass_plans": ENCODER_ROWPASS["ck"]}
    launches = mk.maxsim_keys.launches
    by_variant = dict(mk.maxsim_keys.launches_by_variant)
    if by_variant["mma"]:
        raise AssertionError(f"ck --maxsim launched {by_variant}: dim 128 "
                             f"must take 'wgmma'")
    # the pipeline pads its last tile's doc axis to 8192 masked rows, so
    # the tail is screened like the full tiles
    full_tiles = n_b // mk.MEGA_DOCS
    tiles = -(-n_b // mk.MEGA_DOCS)
    share = M.counts.exact_fallbacks / (n_q * tiles)
    log(f"  ck_main {' '.join(argv[:2])} --maxsim: {wall:.1f} s, kernel "
        f"launches {launches} ({tiles} tiles: {full_tiles} full + a "
        f"{n_b - full_tiles * mk.MEGA_DOCS}-doc tail padded to "
        f"{mk.MEGA_DOCS} rows); queries repaired from their bins "
        f"{M.counts.repaired}, escalated to the 3-pass screen "
        f"{M.counts.escalated}, sent to the exact engine "
        f"{M.counts.exact_fallbacks} of {n_q} x {tiles} (share "
        f"{share:.4f}: the kernel's keys decide the rest)")
    if launches < tiles:
        raise AssertionError("ck --maxsim launched the kernel fewer times "
                             "than it had tiles")
    require_maxsim("ck")

    model = "colbertv2.0"
    data_dir = naming.get_model_data_homedir(
        workdir, model + "_maxsim_synthetic", q_tok, b_tok, k)
    files = naming.get_ivec_fvec_filenames(data_dir, model, 128, b_tok,
                                           q_tok, k)
    maps = naming.get_doc_id_map_filenames(data_dir, model, 128, b_tok,
                                           q_tok)
    mismatches = validate_maxsim_files(data_dir, files[0], files[1], *maps,
                                       files[2], files[3])
    if mismatches != 0:
        raise AssertionError(f"validate_maxsim_files found {mismatches}")
    idx = fvec.read_vectors(files[2])
    dist = fvec.read_vectors(files[3])
    sides, lists = [], []
    for kind, count in (("query", q_tok), ("base", b_tok)):
        mat, ids = _read_doc_tokens(
            f"{data_dir}/{model}_128_{kind}_token{count}_docs_src.parquet")
        lists.append(_split_by_doc(mat, ids))
        sides.append(M.pad_token_lists(lists[-1], 128))
    (qq, qqm), (dd, ddm) = sides
    if idx.shape != (n_q, k) or dd.shape[0] != n_b:
        raise AssertionError(f"unexpected artifact shapes {idx.shape}, "
                             f"{dd.shape}")
    s_e, i_e = M.maxsim_topk(qq, qqm, dd, ddm, k, engine="exact",
                             tile_docs=2048)
    # tie-tolerant: every exported neighbour's written score within 1e-3
    # of its exact score, and no worse than the exact k-th score by more
    dev_t = [torch.as_tensor(x, device="cuda") for x in (qq, qqm, dd, ddm)]
    nb = torch.as_tensor(idx, device="cuda").long()
    got = maxsim_fused.maxsim_pairs_plain(*dev_t, nb, 128)
    written = -torch.as_tensor(dist, device="cuda")
    worst = float((got - written).abs().max())
    below = float((s_e[:, k - 1:k] - got).max())
    same = float((idx == i_e.cpu().numpy()).mean())
    log(f"  exported neighbours vs exact MaxSim on the same parquet: "
        f"identical positions {same:.5f}, max |written - exact score| "
        f"{worst:.3g}, worst shortfall against the exact k-th score "
        f"{below:.3g}")
    if worst > 1e-3 or below > 1e-3:
        raise AssertionError("exported neighbours differ from exact MaxSim")
    oracle_topk_check(*dev_t, written, nb, k, "ck's exported neighbours")
    rec["launches"] = rec["ck_launches"] = launches
    rec["launches_by_variant"] = by_variant
    rec["ck_exact_fallback_share"] = share
    rec["ck_shape"] = ck_kernel_vs_plain(dev_t[0], dev_t[1], lists[1])
    return {"data_dir": data_dir, "files": files, "seconds": wall,
            "qfile": f"{data_dir}/{model}_128_query_token{q_tok}_docs_src"
                     f".parquet",
            "bfile": f"{data_dir}/{model}_128_base_token{b_tok}_docs_src"
                     f".parquet"}


def ck_kernel_vs_plain(q, qm, base_docs):
    """The kernel against its plain version at the shapes ck gives it: the
    run's own query passages and its first full 8192-doc tile, padded as
    compute_maxsim_knn pads it (to a multiple of 16 tokens), at the 3-pass
    tier and the two tiers the stream's controller may downshift to. The
    certified engine would hide wrong keys behind its exact fallback, so
    this comparison, not the run's result, is what holds the kernel."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim as M
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    from neighborhoodwatch_tpu_torch.utils.misc import round_up
    chunk = base_docs[:mk.MEGA_DOCS]
    td = round_up(max(len(c) for c in chunk), 16)
    tile, tmask = M.pad_token_lists(chunk, q.shape[2], max_tokens=td)
    d = torch.as_tensor(tile, device="cuda")
    dm = torch.as_tensor(tmask, device="cuda")
    out = {"Q": q.shape[0], "Tq": q.shape[1], "D": d.shape[0], "Td": td,
           "valid_query_tokens": int(qm.sum(1).max()), "by_passes": {}}
    for passes in (3, 2, 1):
        ops = mk.prepare_operands(q, qm, d, dm, passes, True)[:5]
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = mk.maxsim_keys_plain(*ops, passes)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        errs = {}
        for variant in ("wgmma", "mma"):
            with mk.forced_variant(variant):
                keys = mk.maxsim_keys(*ops, passes)
            errs[variant] = mk.candidates_agree(
                mk.decode_keys(keys), mk.decode_keys(plain), q, qm, d, dm)
        ms_before, ms = turns_ms(
            mk, lambda o=ops, p=passes: mk.maxsim_keys(*o, p))
        out["by_passes"][str(passes)] = {
            "ms": ms, "ms_before": ms_before, "plain_ms": plain_ms,
            "max_abs_err": errs["wgmma"][0]}
        log(f"  kernel vs plain at ck's shapes (Q={out['Q']} Tq={out['Tq']} "
            f"D={out['D']} Td={td}, {passes} passes): wgmma {ms:.2f} ms, mma "
            f"{ms_before:.2f} ms, plain {plain_ms:.1f} ms; max |score| and "
            f"swapped ids (within tolerance): wgmma {errs['wgmma'][0]:.3g}, "
            f"{errs['wgmma'][1]}; mma {errs['mma'][0]:.3g}, "
            f"{errs['mma'][1]}")
    return out


class Tee(io.TextIOBase):
    """stdout that is also kept: the entry points print their sections'
    seconds and the encoder's throughput, which the phase reads back."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def counted_repairs():
    """Count the screened engine's class-A and class-B repairs of every
    call the wrapped region makes (knn() and StreamingKNN.update look the
    engine up in ops.knn at call time); yields the list of per-call
    (class A, class B, whole-batch) triples."""
    from neighborhoodwatch_tpu_torch.ops import knn as K
    real, diags = K.screened_knn_traced, []

    def counted(*args, with_diagnostics=False, **kw):
        d, i, diag = real(*args, with_diagnostics=True, **kw)
        diags.append(diag)
        return (d, i, diag) if with_diagnostics else (d, i)
    K.screened_knn_traced = counted
    try:
        yield diags
    finally:
        K.screened_knn_traced = real


def trace_top_kernels(trace_dir, n=5):
    """The Chrome trace device_trace wrote: (file, [(kernel, ms, calls)])
    for the `n` CUDA kernels with the most device time, or (None, [])."""
    import glob
    paths = sorted(glob.glob(os.path.join(trace_dir, "device_trace_*.json")))
    if not paths:
        return None, []
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    total = {}
    for e in events:
        if e.get("cat") == "kernel":
            ms, calls = total.get(e["name"], (0.0, 0))
            total[e["name"]] = (ms + e.get("dur", 0) / 1e3, calls + 1)
    top = sorted(total.items(), key=lambda kv: -kv[1][0])[:n]
    return paths[-1], [(name[:80], round(ms, 3), calls)
                       for name, (ms, calls) in top]


def nw_sections(text):
    """From nw_main's or ck_main's printed output: {section title:
    seconds} and {section title: (tokens, seconds)} summed over the
    section's `embedding pipeline:` (nw) or `encoder pipeline:` (ck)
    lines."""
    seconds, tokens, title = {}, {}, None
    for line in text.splitlines():
        m = re.match(r"\W*=== (.+) ===", line)
        if m:
            title = m.group(1)
        m = re.match(r"\(Duration: ([\d.]+) s of", line)
        if m and title:
            seconds[title] = float(m.group(1))
        m = re.search(r"(?:embedding|encoder) pipeline: (\d+) tokens in "
                      r"([\d.]+) ?s", line)
        if m and title:
            toks, secs = tokens.get(title, (0, 0.0))
            tokens[title] = (toks + int(m.group(1)), secs + float(m.group(2)))
    return seconds, tokens


def phase_nw(rec, workdir, Q=1000, B=100_000, k=100,
             model="intfloat/e5-large-v2", keep=None):
    """Phase 8; `keep["e5"]` gets (a)'s e5 generator, for phase 14."""
    import torch
    from neighborhoodwatch_tpu_torch.cli import nw_main
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.models import graphed
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    from neighborhoodwatch_tpu_torch.io.parquet_io import read_embeddings
    from neighborhoodwatch_tpu_torch.models.bert import E5_CONFIGS
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.validate import validate_files_v0
    cfg = E5_CONFIGS[model]
    D = cfg.hidden_size
    trace_dir = os.path.join(workdir, "trace")
    argv = [str(Q), str(B), "-k", str(k), "-m", model, "--synthetic",
            "--post-validation", "--yes", "--no-gen-hdf5", "--trace-dir",
            trace_dir, "--data-dir", workdir]
    log(f"  nw_main {' '.join(argv[:6])} ... ({cfg.num_layers} layers, "
        f"{D} hidden, {cfg.num_heads} heads, FFN {cfg.intermediate_size}, "
        f"{cfg.dtype}; seeded random weights)")
    # (a) measured once: the base encode as nw's base set calls it (10,000
    # sentences a call), op by op, on a generator of nw's (seed 0)
    e5 = E5EmbeddingGenerator(model, seed=0, device="cuda")
    texts = base_texts(10_000)
    with graphed.forced_variant("eager"):
        eager = encoder_loop(e5, [texts], workdir, "e5 eager",
                             [texts[:2048]])
    if keep is not None:
        keep["e5"] = e5
    del e5
    reset_counts(sk.screen_keys)
    tee = Tee(sys.stdout)
    # the query set is call 1 and the base set's first phase call 2; call
    # 4, the base set's second 10,000 sentences, is traced
    t = time.perf_counter()
    with counted_repairs() as diags, contextlib.redirect_stdout(tee), \
            verified_counted("nw"), fused_counted("nw"), \
            encoder_counted("nw"), graph_forwards() as forwards, \
            traced_window(E5EmbeddingGenerator, 4, 1, os.path.join(
                workdir, "encode_trace")) as window:
        nw_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    require_graphed(forwards, "nw_main")
    require_encoder("nw", forwards, cfg.num_layers)
    require_default_variant("nw")
    graph = trace_share(os.path.join(workdir, "encode_trace"),
                        window["forwards"])
    log(f"  nw_main base encode, call 4 ({window['texts']} sentences, "
        f"{window['forwards']} forwards) traced: graphed {share_text(graph)}"
        f"; eager (a) {share_text(eager)}")
    require_no_aten_norm(eager, "nw's encoder loop (a), op by op")
    require_no_aten_norm(graph, "nw_main's traced base encode")
    launches = sk.screen_keys.launches
    by_variant = dict(sk.screen_keys.launches_by_variant)
    text = tee.kept.getvalue()
    sections, tokens = nw_sections(text)
    rates = {name: toks / secs for name, (toks, secs) in tokens.items()
             if secs > 0}
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (load_query|load_base|knn_batches|TOTAL)\s+([\d.]+) s", text,
        re.M)}
    class_a = sum(d[0] for d in diags)
    class_b = sum(d[1] for d in diags)
    log(f"  nw_main: {wall:.1f} s; sections (s) {sections}; encoder "
        f"tokens/s {({n: round(r) for n, r in rates.items()})}; kNN stages "
        f"(s) {stages}; kernel launches {launches} {by_variant}; screened "
        f"calls {len(diags)}, class-A repairs {class_a}, class-B repairs "
        f"{class_b}, whole-batch fallbacks {sum(d[2] for d in diags)}")
    if launches < 1:
        raise AssertionError("nw never launched the screen kernel")
    # the screened call: F1 prepares, F3 re-ranks, and the exact fallback
    # of the queries that fail the certificate runs its tiles on F4
    require_fused("nw", ("prepare_base", "rerank_rows", "split_distance"))
    log(f"  nw_main's fused kernel launches: {FUSED_LAUNCHES['nw']} (F3 by "
        f"variant, and the shapes its plan sent to rowwise)")
    if by_variant["mma"] or by_variant["wgmma"] != launches:
        raise AssertionError(f"nw launched {by_variant}: D={D} must take "
                             f"'wgmma'")
    trace_file, top = trace_top_kernels(trace_dir)
    if trace_file is None:
        log("  trace: none written (see the warnings above)")
    else:
        log(f"  trace: {os.path.getsize(trace_file)} bytes; top CUDA kernels "
            f"by device time (name, ms, calls): {top}")

    data_dir = naming.get_model_data_homedir(workdir, model + "_synthetic",
                                             Q, B, k)
    files = naming.get_ivec_fvec_filenames(
        data_dir, naming.get_model_prefix(model), D, B, Q, k)
    mismatches = validate_files_v0(data_dir, *files)
    if mismatches != 0:
        raise AssertionError(f"validate_files_v0 found {mismatches}")
    idx = fvec.read_vectors(files[2])
    dist = fvec.read_vectors(files[3])
    qfile = naming.get_source_query_dataset_filename(data_dir, model, Q, D)
    bfile = naming.get_source_base_dataset_filename(data_dir, model, B, D)
    q = torch.as_tensor(read_embeddings(data_dir, qfile, Q, D), device="cuda")
    base = torch.as_tensor(read_embeddings(data_dir, bfile, B, D),
                           device="cuda")
    d_e, i_e = K.knn(q, base, k, engine="exact")
    got = torch.as_tensor(idx, device="cuda").long()
    # each exported neighbour's squared distance, recomputed in fp32; a
    # neighbour outside the exact engine's set counts as found when it
    # ties the exact k-th distance within 1e-5
    d_got = ((q[:, None, :] - base[got]) ** 2).sum(2)
    found = (got[:, :, None] == i_e.long()[:, None, :]).any(2)
    tied = d_got <= d_e[:, k - 1:k] + 1e-5
    recall = float(found.float().mean())
    recall_tied = float((found | tied).float().mean())
    written = torch.as_tensor(dist, device="cuda")
    dd = (written - d_e).abs()
    moved = got != i_e.long()
    ties_ok = bool((~moved | (dd <= 1e-5)).all())
    log(f"  ivec vs exact engine: recall {recall:.4f}, tie-tolerant recall "
        f"{recall_tied:.4f}, identical positions "
        f"{1 - float(moved.float().mean()):.5f}, max |d_written - d_exact| "
        f"{float(dd.max()):.3g}, max |d_recomputed - d_written| "
        f"{float((d_got - written).abs().max()):.3g}; distance spread of "
        f"the run (k-th minus 1st, mean) "
        f"{float((d_e[:, -1] - d_e[:, 0]).mean()):.4g}")
    if idx.shape != (Q, k) or recall_tied != 1.0 or not ties_ok:
        raise AssertionError("nw's neighbours differ from the exact engine")
    # the same kNN call at each screen tier against the exact engine:
    # which tier's certificate holds on this run's crowded embeddings
    exact_ms = median_ms(lambda: K.knn(q, base, k, engine="exact"))
    tiers = {}
    for sp in ("auto", "medium", "high"):
        with counted_repairs() as dg:
            K.knn(q, base, k, engine="screened", screen_precision=sp)
        tiers[sp] = {"ms": median_ms(lambda sp=sp: K.knn(
            q, base, k, engine="screened", screen_precision=sp)),
            "class_a": dg[0][0], "class_b": dg[0][1],
            "whole_batch": dg[0][2]}
    log(f"  knn() on the run's queries and base, medians of 3: exact "
        f"{exact_ms:.1f} ms; screened by tier (ms, class-A, class-B, "
        f"whole-batch fallback): " + "; ".join(
            f"{sp} {v['ms']:.1f}, {v['class_a']}, {v['class_b']}, "
            f"{v['whole_batch']}" for sp, v in tiers.items()))

    # ---- the kernel at the run's own shapes ----
    sub = sk.pick_sub(B, k, q_rows=Q)
    mega = sk.TB * sub
    qhi_f = sk.bf16_round(q)
    ops = dict(qhi=qhi_f.to(torch.bfloat16),
               qlo=(q - qhi_f).to(torch.bfloat16), qn=(q * q).sum(1))
    first = base[:mega]
    bhi = sk.bf16_round(first).to(torch.bfloat16)
    ops.update(bhi=bhi, blo=(first - bhi.float()).to(torch.bfloat16),
               bn=(first * first).sum(1))
    errs = {}
    for passes in (1, 2, 3):
        kp = sk.screen_keys_plain(**ops, mega_rows=mega, passes=passes,
                                  epilogue="l2")
        kk = sk.screen_keys(**ops, mega_rows=mega, passes=passes,
                            epilogue="l2")
        errs[passes] = compare_keys(kk, kp, "l2", mega, q, first)
    log(f"  kernel [{sk.pick_variant(D, True)}] vs plain on the run's "
        f"{Q} queries and first mega-tile ({mega} rows, sub={sub}, D={D}): "
        + "; ".join(f"{p}-pass max |d| {e:.3g}, swapped ids (within "
                    f"tolerance) {sw}" for p, (e, sw) in errs.items()))
    # the kernel and its plain version on the whole batch the run screened
    bhi_all = sk.bf16_round(base).to(torch.bfloat16)
    full = dict(qhi=ops["qhi"], qlo=ops["qlo"], bhi=bhi_all, blo=None,
                qn=ops["qn"], bn=(base * base).sum(1))
    ms = event_ms(lambda: sk.screen_keys(**full, mega_rows=mega, passes=1,
                                         epilogue="l2"))
    plain_ms = event_ms(lambda: sk.screen_keys_plain(
        **full, mega_rows=mega, passes=1, epilogue="l2"))
    library_ms = event_ms(lambda: torch.mm(full["qhi"], bhi_all.T))
    flops = 2.0 * Q * B * D
    n_mega = -(-B // mega)
    bytes_ = Q * D * 2 + B * D * 2 + Q * 4 + B * 4 + Q * n_mega * 512 * 4
    bound = max(flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES) * 1e3
    log(f"  kernel at the run's batch ({Q} x {B} x {D}, 1 pass, sub={sub}): "
        f"{ms:.2f} ms, plain {plain_ms:.2f} ms, torch.mm of the bf16 "
        f"operands {library_ms:.2f} ms, bound {bound:.3f} ms "
        f"({'operations' if flops / PEAK_BF16_FLOPS >= bytes_ / PEAK_BYTES else 'bytes'})")
    del q, base, ops, first, full, bhi_all, d_e, i_e
    torch.cuda.empty_cache()
    rec["nw_launches"] = launches
    rec["nw_launches_by_variant"] = by_variant
    rec["nw_shape"] = {
        "Q": Q, "B": B, "D": D, "sub": sub, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "library_ms": library_ms,
        "max_abs_err_by_passes": {str(p): e for p, (e, _) in errs.items()},
        "repairs": {"class_a": class_a, "class_b": class_b},
        "exact_ms": exact_ms, "tiers": tiers,
        "sections_s": sections, "encoder_tokens_per_s": rates,
        "knn_stages_s": stages, "wall_s": wall,
        "trace_top_kernels": top,
        "encoder": {"eager": eager, "graph_trace": graph,
                    "forwards": forwards,
                    "fused_launches": ENCODER_LAUNCHES["nw"],
                    "fused_launches_by_variant": ENCODER_VARIANTS["nw"],
                    "rowpass_plans": ENCODER_ROWPASS["nw"]}}
    return files


def phase_tools(rec, workdir, files, k=100):
    from neighborhoodwatch_tpu_torch import tools
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    out_dir = os.path.join(workdir, "tools")
    os.makedirs(out_dir)
    reset_counts(sk.screen_keys)
    tee = Tee(sys.stdout)
    t = time.perf_counter()
    with counted_repairs() as diags, contextlib.redirect_stdout(tee), \
            verified_counted("nw_tools"):
        tools.main(["knn", files[0], files[1], "-k", str(k), "--out-dir",
                    out_dir])
    wall = time.perf_counter() - t
    launches = sk.screen_keys.launches
    by_variant = dict(sk.screen_keys.launches_by_variant)
    report = json.loads(tee.kept.getvalue().strip().splitlines()[-1])
    log(f"  nw-tools knn: {wall:.1f} s, kernel launches {launches} "
        f"{by_variant}, class-A repairs {sum(d[0] for d in diags)}, "
        f"class-B {sum(d[1] for d in diags)}")
    if launches < 1 or by_variant["mma"]:
        raise AssertionError(f"nw-tools knn launched {by_variant}")
    got, want = fvec.read_vectors(report["indices"]),         fvec.read_vectors(files[2])
    gd, wd = fvec.read_vectors(report["distances"]),         fvec.read_vectors(files[3])
    moved = got != want
    dd = np.abs(gd - wd)
    # ids may differ only where the two distances tie within 1e-5, and the
    # k-th boundary only between ties of the k-th distance
    if got.shape != want.shape or bool((moved & (dd > 1e-5)).any()):
        raise AssertionError("nw-tools knn ivec differs from nw's")
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        tools.main(["recall", files[2], report["indices"],
                    "--truth-distances", files[3]])
    recall = json.loads(tee.kept.getvalue().strip().splitlines()[-1])
    log(f"  ivec vs nw's: identical positions "
        f"{1 - float(moved.mean()):.5f}, max |d - d_nw| {float(dd.max()):.3g};"
        f" recall (tie-aware) {recall['recall']:.4f}, perfect queries "
        f"{recall['perfect_queries']} of {recall['queries']}")
    if recall["recall"] != 1.0:
        raise AssertionError("nw-tools recall of the two ivecs is not 1.0")
    rec["tools_launches"] = launches
    rec["tools_launches_by_variant"] = by_variant
    rec["tools_wall_s"] = wall

def ragged_mask(lengths, T):
    """(len(lengths), T) int32 mask on the card, row i valid up to
    lengths[i]."""
    import torch
    n = torch.as_tensor(lengths, device="cuda")[:, None]
    return (torch.arange(T, device="cuda")[None] < n).to(torch.int32)


def attention_kernel_vs_plain():
    """Phase 10(a): both variants against the plain version on every row
    (attention_kernel.outputs_agree), int32 and bool masks: bf16 and fp16
    on "mma" and "wgmma", fp32 on "mma" (wgmma would read fp32 as TF32).
    Returns the worst max |d| per variant and dtype."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    g = torch.Generator(device="cuda").manual_seed(10)
    worst = {}
    combos = [(torch.bfloat16, "mma"), (torch.bfloat16, "wgmma"),
              (torch.float16, "mma"), (torch.float16, "wgmma"),
              (torch.float32, "mma")]
    for dtype, variant in combos:
        for T in (128, 256, 512):
            for H, D in ((12, 64), (16, 64), (16, 128)):
                q, k, v = (torch.randn((5, T, H, D), device="cuda",
                                       generator=g).to(dtype)
                           for _ in range(3))
                seg = ragged_mask([1, 37, T - 1, T, 0], T)
                plain = ak.masked_attention_plain(q, k, v, seg, D ** -0.5)
                for mask in (seg, seg.bool()):
                    with ak.forced_variant(variant):
                        out = ak.masked_attention(q, k, v, mask, D ** -0.5)
                    torch.cuda.synchronize()
                    err = ak.outputs_agree(out, plain)
                    key = f"{variant} {str(dtype).split('.')[1]}"
                    worst[key] = max(worst.get(key, 0.0), err)
    log(f"  (a) 18 cases per variant and dtype (T 128/256/512 x (H, D) (12, "
        f"64)/(16, 64)/(16, 128) x int32/bool masks; valid lengths 1, 37, "
        f"T-1, T, 0), every row: max |kernel - plain| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + " (tolerance: fp32 "
        "1e-5 abs, bf16 / fp16 2 ulps of the row's largest |o|)")
    return worst


def bucket_texts(n, T, rng):
    """n texts of T/2 + 1 .. T hash tokens (CLS and SEP included), the
    first exactly T: bucket T of the tokenizer."""
    lengths = rng.integers(T // 2 + 1, T + 1, size=n)
    lengths[0] = T
    return [" ".join(f"w{j}" for j in rng.integers(0, 5000, size=L - 2))
            for L in lengths]


def embeddings_agree(a, b):
    """(max |a - b|, least cosine of matching rows) of two (N, dim)
    arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1)
                                      * np.linalg.norm(b, axis=1), 1e-30)
    return float(np.abs(a - b).max()), float(cos.min())


def attention_e5(rec, tokens=131_072, model="intfloat/e5-large-v2"):
    """Phase 10(b): the e5 generator with the flash config and with "auto"
    on one state, ~`tokens` ragged tokens per forward in buckets 128, 256
    and 512. Returns {T: (ids, mask)} for the timings of (d)."""
    import dataclasses
    import torch
    from neighborhoodwatch_tpu_torch.models import bert as bert_mod
    from neighborhoodwatch_tpu_torch.models import graphed
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    cfg = bert_mod.E5_CONFIGS[model]
    t = time.perf_counter()
    auto = E5EmbeddingGenerator(model, seed=0, device="cuda")
    bert_mod.E5_CONFIGS[model] = dataclasses.replace(cfg,
                                                     attention_impl="flash")
    try:
        flash = E5EmbeddingGenerator(model, state=auto.model.state_dict(),
                                     device="cuda")
    finally:
        bert_mod.E5_CONFIGS[model] = cfg
    log(f"  (b) {model} ({cfg.num_layers} layers, {cfg.hidden_size} hidden,"
        f" {cfg.num_heads} heads, FFN {cfg.intermediate_size}, {cfg.dtype};"
        f" seeded random weights), generators with attention_impl "
        f"'{flash.config.attention_impl}' and '{auto.config.attention_impl}'"
        f" on one state: {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(10)
    batches, per_bucket, launches, by_variant = {}, {}, 0, {}
    worst_d, worst_cos = 0.0, 1.0
    for T in (128, 256, 512):
        texts = bucket_texts(tokens // T, T, rng)
        ids, mask = flash.tokenizer(texts, max_length=512)
        assert ids.shape == (tokens // T, T), ids.shape
        ids = torch.from_numpy(ids).to("cuda", torch.long)
        mask = torch.from_numpy(mask).to("cuda")
        batches[T] = (ids, mask)
        # the main path: the generator's own encode of one chunk, a replay
        # of the graph that its first encode captured
        flash._encode(texts)
        reset_counts(ak.masked_attention)
        got = flash._encode(texts)
        torch.cuda.synchronize()
        n = ak.masked_attention.launches
        n_wgmma = ak.masked_attention.launches_by_variant["wgmma"]
        launches += n
        for name, count in ak.masked_attention.launches_by_variant.items():
            by_variant[name] = by_variant.get(name, 0) + count
        if n != cfg.num_layers or n_wgmma != n:
            raise AssertionError(f"bucket {T}: {n} launches per forward "
                                 f"({n_wgmma} wgmma), expected "
                                 f"{cfg.num_layers}, all wgmma")
        with graphed.forced_variant("eager"):
            want = auto._encode(texts)
        d, cos = embeddings_agree(got.cpu(), want.cpu())
        worst_d, worst_cos = max(worst_d, d), min(worst_cos, cos)

        @torch.no_grad()
        def forward(gen):
            return bert_mod.mean_pool_normalize(gen.model(ids, mask), mask)
        ms = {}
        for name, gen in (("flash", flash), ("auto", auto), ("auto", auto),
                          ("flash", flash)):
            forward(gen)
            ms.setdefault(name, []).append(median_ms(lambda: forward(gen)))
        valid = int(mask.sum())
        per_bucket[str(T)] = {
            "batch": tokens // T, "valid_tokens": valid,
            "launches": n, "max_abs_diff": d, "min_cosine": cos}
        for name in ("flash", "auto"):
            sec = float(np.mean(ms[name])) / 1e3
            per_bucket[str(T)][f"{name}_ms"] = sec * 1e3
            per_bucket[str(T)][f"{name}_tokens_per_s"] = valid / sec
            per_bucket[str(T)][f"{name}_padded_tokens_per_s"] = tokens / sec
        r = per_bucket[str(T)]
        log(f"  (b) bucket {T}: {tokens // T} texts, {valid} valid of "
            f"{tokens} tokens; launches per forward {n}; forward + pooling "
            f"(median of 3, in turns flash, auto, auto, flash): flash "
            f"{r['flash_ms']:.1f} ms ({r['flash_tokens_per_s']:.0f} valid, "
            f"{r['flash_padded_tokens_per_s']:.0f} padded tokens/s), auto "
            f"{r['auto_ms']:.1f} ms ({r['auto_tokens_per_s']:.0f}, "
            f"{r['auto_padded_tokens_per_s']:.0f}); pooled embeddings flash "
            f"vs auto: max |d| {d:.3g}, least cosine {cos:.6f}")
    # the same texts cut to bucket 64: outside the gate, no launch
    texts = bucket_texts(tokens // 128, 128, np.random.default_rng(11))
    flash.max_length = 64
    reset_counts(ak.masked_attention)
    flash._encode(texts)
    torch.cuda.synchronize()
    flash.max_length = 512
    if ak.masked_attention.launches != 0:
        raise AssertionError("bucket 64 launched the attention kernel")
    log(f"  (b) the bucket-128 texts cut to bucket 64: "
        f"{ak.masked_attention.launches} launches")
    # bf16 activations through 24 layers: the two attentions round p at
    # other places and "auto" stores its logits in bf16
    if worst_d > 5e-2 or worst_cos < 0.999:
        raise AssertionError(f"flash and auto e5 embeddings differ: max |d| "
                             f"{worst_d:.3g}, least cosine {worst_cos:.6f}")
    rec["launches"] = rec["e5_launches"] = launches
    rec["launches_by_variant"] = by_variant
    rec["e5"] = per_bucket
    del flash, auto
    torch.cuda.empty_cache()
    return batches


def attention_colbert(rec, n=512):
    """Phase 10(c): the ColBERT generator at bert-base width with the flash
    config and with "auto" on one state, passages in bucket 128."""
    import dataclasses
    import torch
    from neighborhoodwatch_tpu_torch.models import bert as bert_mod
    from neighborhoodwatch_tpu_torch.models import colbert as cb
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    cfg = cb.COLBERT_BASE_CONFIG
    model = cb.ColbertModel(cfg)
    bert_mod.init_params(model, seed=0)
    state = model.state_dict()
    gens = {impl: cb.ColbertEmbeddingGenerator(
        state=state, device="cuda",
        config=dataclasses.replace(cfg, attention_impl=impl))
        for impl in ("flash", "auto")}
    rng = np.random.default_rng(12)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 5000, size=L - 2))
             for L in rng.integers(65, 129, size=n)]
    out, wall = {}, {}
    for impl in ("flash", "auto"):
        gens[impl].encode_passages(texts, batch_size=64)    # captures
        reset_counts(ak.masked_attention)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[impl] = gens[impl].encode_passages(texts, batch_size=64)
        torch.cuda.synchronize()
        wall[impl] = time.perf_counter() - t
        if impl == "flash":
            launches = ak.masked_attention.launches
            by_variant = dict(ak.masked_attention.launches_by_variant)
    forwards = -(-n // 64)
    (fe, fc), (ae, ac) = out["flash"], out["auto"]
    if fc != ac or not all(65 <= c <= 128 for c in fc):
        raise AssertionError("flash and auto token counts differ")
    d, cos = embeddings_agree(fe, ae)
    log(f"  (c) ColBERT (bert-base, {cfg.num_layers} layers, bf16, seeded "
        f"random weights) encode_passages over {n} passages of 65-128 "
        f"tokens (bucket 128, {forwards} forwards): launches {launches}; "
        f"{wall['flash']:.2f} s flash, {wall['auto']:.2f} s auto; "
        f"{len(fe)} valid tokens, flash vs auto: max |d| {d:.3g}, least "
        f"cosine {cos:.6f}")
    if launches != cfg.num_layers * forwards or by_variant["wgmma"] != \
            launches:
        raise AssertionError(f"ColBERT launched {launches} ({by_variant}), "
                             f"expected {cfg.num_layers * forwards} wgmma")
    if d > 5e-2 or cos < 0.999:
        raise AssertionError("flash and auto ColBERT embeddings differ")
    rec["colbert_launches"] = launches
    rec["colbert_launches_by_variant"] = by_variant
    rec["colbert"] = {"passages": n, "forwards": forwards,
                      "valid_tokens": len(fe), "max_abs_diff": d,
                      "min_cosine": cos}
    del gens, model, state
    torch.cuda.empty_cache()


def tile_pair_flops(seg, H, D, tile=128):
    """The products the "wgmma" variant computes on these segment ids: 4 *
    tile^2 * D per head for every pair of 128-row query and key tiles whose
    sets of (id & 31) meet (the tiles it does not skip)."""
    import torch
    B, T = seg.shape
    sets = torch.nn.functional.one_hot((seg.long() & 31), 32).view(
        B, T // tile, tile, 32).any(2)
    pairs = (sets[:, :, None] & sets[:, None]).any(-1).sum()
    return 4.0 * H * D * tile * tile * float(pairs)


def attention_timings(rec, batches, H=16, D=64):
    """Phase 10(d): at e5-large's shapes with (b)'s ragged masks, the two
    kernel variants (CUDA events around REPS calls back to back, median of
    3, in turns mma, wgmma, wgmma, mma) against their bound, the plain
    version, the written-out attention and torch's
    scaled_dot_product_attention with the (B, 1, T, T) segment mask (REPS
    calls too)."""
    import torch
    import torch.nn.functional as F
    from neighborhoodwatch_tpu_torch.models.bert import written_out_attention
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    g = torch.Generator(device="cuda").manual_seed(13)
    shapes = {}
    for T, (_, mask) in batches.items():
        B = mask.shape[0]
        q, k, v = (torch.randn((B, T, H, D), device="cuda",
                               generator=g).to(torch.bfloat16)
                   for _ in range(3))
        seg, key_mask = mask.to(torch.int32), mask.bool()
        scale = D ** -0.5
        variant = ak.pick_variant(T, D, q.dtype, True)

        def kernel():
            return ak.masked_attention(q, k, v, key_mask, scale)

        def kernel_reps():
            # back to back: the card's time, not the wrapper's on the host
            for _ in range(REPS):
                kernel()

        def written():
            return written_out_attention(q, k, v, key_mask)
        ms_before, ms = (x / REPS for x in turns_ms(ak, kernel_reps))
        written()
        written_ms = event_ms(written)
        plain = ak.masked_attention_plain(q, k, v, seg, scale)
        err = {}
        for name in ak.VARIANTS:
            with ak.forced_variant(name):
                err[name] = ak.outputs_agree(kernel(), plain)
        del plain
        plain_ms = event_ms(lambda: ak.masked_attention_plain(
            q, k, v, seg, scale))
        torch.cuda.empty_cache()
        same = (seg[:, :, None] == seg[:, None, :])[:, None]   # (B,1,T,T)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = event_ms(lambda: [F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=same, scale=scale) for _ in range(REPS)]
        ) / REPS
        del same
        torch.cuda.empty_cache()
        n_valid = mask.sum(1).double()
        dense_flops = 4.0 * B * H * T * T * D
        # a query's own segment only, and what the 128-row skip computes
        flops = float(4.0 * H * D * (n_valid ** 2 + (T - n_valid) ** 2)
                      .sum())
        tile_flops = tile_pair_flops(seg, H, D)
        bytes_ = 4 * B * T * H * D * 2 + B * T * 4
        bound = max(bytes_ / PEAK_BYTES, tile_flops / PEAK_BF16_FLOPS) * 1e3
        shapes[str(T)] = {
            "B": B, "H": H, "D": D, "variant": variant, "ms": ms,
            "ms_before": ms_before, "plain_ms": plain_ms,
            "library_ms": library_ms, "written_out_ms": written_ms,
            "bound_ms": bound, "bound_by": "bytes" if bytes_ / PEAK_BYTES
            >= tile_flops / PEAK_BF16_FLOPS else "operations",
            "flops": flops, "tile_flops": tile_flops,
            "dense_flops": dense_flops, "bytes": bytes_,
            "max_abs_err": err[variant], "max_abs_err_mma": err["mma"]}
        log(f"  (d) T={T} B={B} H={H} D={D} bf16, ragged: {variant} {ms:.3f}"
            f" ms ({ms / bound:.2f}x bound, {ms / library_ms:.2f}x SDPA), "
            f"mma {ms_before:.3f} ms (in turns mma, wgmma, wgmma, mma; "
            f"{REPS} calls a timing); "
            f"written-out {written_ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"SDPA with the segment mask {library_ms:.3f} ms; bound "
            f"{bound:.3f} ms ({shapes[str(T)]['bound_by']}: "
            f"{bytes_ / 1e9:.3f} GB; {tile_flops / 1e9:.1f} GFLOP on the "
            f"unskipped tiles, {flops / 1e9:.1f} needed, "
            f"{dense_flops / 1e9:.1f} dense); kernel vs plain max |d| "
            f"{err[variant]:.3g} ({variant}), {err['mma']:.3g} (mma)")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    main = shapes["512"]
    rec.update({key: main[key] for key in
                ("variant", "ms", "ms_before", "plain_ms", "bound_ms",
                 "bound_by", "library_ms", "written_out_ms", "max_abs_err")})
    rec["shapes"] = shapes


def phase_attention(rec):
    rec["kernel_vs_plain_max_abs_err"] = attention_kernel_vs_plain()
    batches = attention_e5(rec)
    attention_colbert(rec)
    attention_timings(rec, batches)


# ------------------------------------------------------------ phase 11

# (d): the two gloo ranks on the one card, run as this script with
# MESH_RANK_FLAG; 100,000 base rows a rank (>= 2 mega-tiles: the screen
# kernel launches on each rank), and MaxSim tiles of 2 x 8192 docs
MESH_RANK_FLAG = "--mesh-rank"
TWO_RANK_KNN = (10_000, 200_000, 1536, 100)         # Q, B, D, k
TWO_RANK_MAXSIM = (1000, 32, 4 * 8192, 16, 128, 100)  # Q, Tq, docs, Td, dim, k
TWO_RANK_TILE = 2 * 8192
TWO_RANK_TIMEOUT_S = 420


def knn_agree(d_a, i_a, d_b, i_b, what, tol=1e-5):
    """Two (Q, k) kNN results, tie-tolerant: every distance within `tol` of
    the reference's at its position, ids different only where the two
    distances tie within `tol`."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    d_a, d_b = host(d_a).astype(np.float64), host(d_b).astype(np.float64)
    moved = host(i_a) != host(i_b)
    dd = np.abs(d_a - d_b)
    log(f"  {what}: identical positions {1 - float(moved.mean()):.5f}, "
        f"max |d - d_ref| {float(dd.max()):.3g}")
    if d_a.shape != d_b.shape or float(dd.max()) > tol:
        raise AssertionError(f"{what}: distances differ from the reference")


def maxsim_agree(s_a, i_a, s_b, i_b, k, what):
    """check_against_exact on host or card arrays."""
    import torch
    s_a, i_a, s_b, i_b = (torch.as_tensor(np.asarray(x.cpu()) if
                                          hasattr(x, "cpu") else x)
                          for x in (s_a, i_a, s_b, i_b))
    check_against_exact(s_a, i_a, s_b, i_b, k, what)


def counted_run(launches, name, wrapper, fn):
    """`fn()` with `wrapper`'s launch counts set to 0 just before and read
    just after into launches[name] (by variant), and the verified select's
    into VERIFIED_LAUNCHES[name]; returns (result, seconds)."""
    import torch
    reset_counts(wrapper)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with verified_counted(name), maxsim_counted(name):
        out = fn()
    torch.cuda.synchronize()
    launches[name] = dict(wrapper.launches_by_variant)
    return out, time.perf_counter() - t


def require_wgmma(launches, name):
    by = launches[name]
    if by["wgmma"] < 1 or by["mma"]:
        raise AssertionError(f"{name} launched {by}: the mesh path must "
                             f"launch the 'wgmma' kernel")


def maxsim_corpus():
    """Phase 6's first corpus, made anew from its seed: 1,000 query
    passages x 32 tokens and 200,000 docs x 16 tokens at 128 dims."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = unit_tokens(1000, 32, 128, gen)
    d = unit_tokens(200_000, 16, 128, gen)
    return (q, torch.ones(q.shape[:2], dtype=torch.bool, device="cuda"), d,
            torch.ones(d.shape[:2], dtype=torch.bool, device="cuda"))


def two_rank_data():
    """(d)'s inputs, the same on every process: unit rows and tokens."""
    import torch
    Q, B, D, _ = TWO_RANK_KNN
    g = torch.Generator(device="cuda").manual_seed(11)
    q = unit_rows(Q, D, g)
    base = unit_rows(B, D, g)
    mq_n, tq, n_docs, td, dim, _ = TWO_RANK_MAXSIM
    gm = torch.Generator(device="cuda").manual_seed(12)
    mq = unit_tokens(mq_n, tq, dim, gm)
    md = unit_tokens(n_docs, td, dim, gm)
    return q, base, mq, md


def two_rank_paths(mesh, launches):
    """The three mesh paths of (d) on `mesh`: {name: (result, seconds)}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as SM
    q, base, mq, md = two_rank_data()
    k = TWO_RANK_KNN[3]
    out = {}
    out["sharded_knn"] = counted_run(
        launches, "sharded_knn", sk.screen_keys,
        lambda: [x.cpu().numpy() for x in SK.sharded_knn(q, base, k, mesh)])

    def stream_knn():
        acc = SK.ShardedStreamingKNN(q, k, mesh)
        acc.update(base, 0)
        return acc.finalize()
    out["sharded_streaming_knn"] = counted_run(
        launches, "sharded_streaming_knn", sk.screen_keys, stream_knn)
    mqm = torch.ones(mq.shape[:2], dtype=torch.bool, device=mq.device)
    mdm = torch.ones(md.shape[:2], dtype=torch.bool, device=md.device)

    def stream_maxsim_():
        acc = SM.ShardedStreamingMaxSim(mq, mqm, TWO_RANK_MAXSIM[5], mesh)
        for s in range(0, md.shape[0], TWO_RANK_TILE):
            acc.update(md[s:s + TWO_RANK_TILE], mdm[s:s + TWO_RANK_TILE])
        return acc.finalize()
    out["sharded_streaming_maxsim"] = counted_run(
        launches, "sharded_streaming_maxsim", mk.maxsim_keys, stream_maxsim_)
    del q, base, mq, md
    torch.cuda.empty_cache()
    return out


def mesh_rank_main(argv):
    """One rank of (d): `chip_smoke.py --mesh-rank RANK WORLD PORT OUT`.
    Joins a gloo group on cuda:0, runs the three mesh paths and writes its
    results, launches and seconds to OUT/rank<RANK>.npz."""
    from datetime import timedelta
    import torch
    from neighborhoodwatch_tpu_torch import resolve_device
    from neighborhoodwatch_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh,
    )
    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    resolve_device()
    init_distributed(coordinator=f"localhost:{port}", num_processes=world,
                     process_id=rank, device="cuda:0", backend="gloo",
                     timeout=timedelta(seconds=180))
    mesh = make_mesh(world, device="cuda:0")
    assert mesh.backend == "gloo" and mesh.stage
    launches = {}
    res = two_rank_paths(mesh, launches)
    arrays = {f"{name}.{j}": np.asarray(r[j]) for name, (r, _) in res.items()
              for j in (0, 1)}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays,
             launches=json.dumps(launches),
             seconds=json.dumps({n: sec for n, (_, sec) in res.items()}))
    torch.distributed.destroy_process_group()


def two_rank_run(workdir, reference, rec, mrec):
    """(d): two ranks of this script on the one card over gloo; each must
    equal the world-size-1 `reference`. A failed rank fails the run, and a
    rank still running at the deadline is killed."""
    import socket
    out = os.path.join(workdir, "two_rank")
    os.makedirs(out)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"  (d) two gloo ranks on cuda:0 (compute mode "
        f"{smi.stdout.strip() or 'unknown'})")
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), MESH_RANK_FLAG, str(r),
         "2", str(port), out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of the two-rank run exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
    wall = time.perf_counter() - t
    per_rank = []
    for r in range(2):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            got = {key: z[key] for key in z.files}
        launches = json.loads(str(got["launches"]))
        seconds = json.loads(str(got["seconds"]))
        per_rank.append(launches)
        for name in ("sharded_knn", "sharded_streaming_knn",
                     "sharded_streaming_maxsim"):
            require_wgmma(launches, name)
            ref = reference[name][0]
            a, b = got[f"{name}.0"], got[f"{name}.1"]
            what = (f"(d) rank {r} {name} vs world size 1 (gloo, correctness "
                    f"only: {seconds[name]:.2f} s is not a speed figure)")
            if name.endswith("maxsim"):
                maxsim_agree(a, b, ref[0], ref[1], TWO_RANK_MAXSIM[5], what)
            else:
                knn_agree(a, b, ref[0], ref[1], what)
    rec["mesh_launches"]["two_rank_gloo"] = [
        {n: v for n, v in rank.items() if n != "sharded_streaming_maxsim"}
        for rank in per_rank]
    mrec["mesh_launches"]["two_rank_gloo"] = [
        rank["sharded_streaming_maxsim"] for rank in per_rank]
    log(f"  (d) two ranks: {wall:.1f} s wall, processes started included "
        f"(correctness run; multi-rank speed is not measurable on one "
        f"card); launches per rank {per_rank}")
    return wall


def mesh_knn(rec, ref, mesh, secs):
    """(a): the kNN mesh paths at world size 1 over phase 3's data."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.parallel import sharded_knn as SK
    k = 100
    q, base = engine_data()
    step = base.shape[0] // 4
    launches = rec["mesh_launches"]

    def stream():
        acc = SK.ShardedStreamingKNN(q, k, mesh)
        for s in range(0, base.shape[0], step):
            acc.update(base[s:s + step], s)
        return acc.finalize()
    with counted_repairs() as diags:
        (d, i), secs["sharded_streaming_knn"] = counted_run(
            launches, "sharded_streaming_knn", sk.screen_keys, stream)
    knn_agree(d, i, ref["d"], ref["i"],
              f"(a) ShardedStreamingKNN, 4 batches of 250,000 (class-A, "
              f"class-B, whole-batch repairs per fold {diags}), vs phase 3's "
              f"knn()")
    (d, i), secs["sharded_knn"] = counted_run(
        launches, "sharded_knn", sk.screen_keys,
        lambda: SK.sharded_knn(q, base, k, mesh))
    knn_agree(d, i, ref["d"], ref["i"], "(a) sharded_knn vs phase 3's knn()")
    (d, i), secs["ring_knn"] = counted_run(
        launches, "ring_knn", sk.screen_keys,
        lambda: SK.ring_knn(q[:1000], base, k, mesh))
    knn_agree(d, i, ref["d"][:1000], ref["i"][:1000],
              "(a) ring_knn on 1,000 queries vs phase 3's knn()")
    require_wgmma(launches, "sharded_streaming_knn")
    require_wgmma(launches, "sharded_knn")
    log(f"  (a) seconds at 10,000 x 1,000,000 x 1536, k=100 (one call each, "
        f"synchronized): ShardedStreamingKNN {secs['sharded_streaming_knn']:.3f}"
        f", sharded_knn {secs['sharded_knn']:.3f}, ring_knn (1,000 queries, "
        f"exact engine) {secs['ring_knn']:.3f}; phase 3's knn(): first call "
        f"{ref['first_s']:.3f}, median of 3 {ref['median_ms'] / 1e3:.3f}; "
        f"launches {dict((n, launches[n]) for n in ('sharded_streaming_knn', 'sharded_knn', 'ring_knn'))}")
    del q, base, d, i
    torch.cuda.empty_cache()


def mesh_pipelines(rec, kept, mesh, secs):
    """(b): compute_knn_ds(mesh) over phase 4's parquet, then nw_main
    --mesh 1 over a copy of phase 8's embeddings."""
    from neighborhoodwatch_tpu_torch.cli import nw_main
    from neighborhoodwatch_tpu_torch.core.pipeline import compute_knn_ds
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.io.export import generate_output_files
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.validate import validate_files_v0
    launches = rec["mesh_launches"]
    p4 = kept["pipeline"]
    Q, B, D, k = p4["shape"]
    files = p4["files"]
    idx4, dist4 = fvec.read_vectors(files[2]), fvec.read_vectors(files[3])
    for f in files[2:]:                # written again from the mesh run
        os.remove(f)
    _, secs["compute_knn_ds"] = counted_run(
        launches, "compute_knn_ds", sk.screen_keys,
        lambda: compute_knn_ds(p4["data_dir"], D, p4["qfile"], Q,
                               p4["bfile"], B, k=k,
                               initial_batch_size=100_000, mesh=mesh))
    model = "text-embedding-ada-002"
    files = generate_output_files(
        p4["data_dir"], model, D, p4["bfile"], p4["qfile"], B, Q,
        naming.get_partial_indices_filename(p4["data_dir"], -1),
        naming.get_partial_distances_filename(p4["data_dir"], -1), k,
        output_hdf5=False)
    mismatches = validate_files_v0(p4["data_dir"], *files)
    knn_agree(fvec.read_vectors(files[3]), fvec.read_vectors(files[2]),
              dist4, idx4, f"(b) compute_knn_ds(mesh) ivec vs phase 4's "
              f"(validate_files_v0 mismatches {mismatches})")
    if mismatches:
        raise AssertionError(f"validate_files_v0 found {mismatches}")
    require_wgmma(launches, "compute_knn_ds")

    # nw_main --mesh 1 over a copy of phase 8's embeddings parquet
    nw = kept["nw"]
    Q, B, k, model, D = nw["Q"], nw["B"], nw["k"], nw["model"], nw["D"]
    root = os.path.join(nw["workdir"], "mesh")
    src = naming.get_model_data_homedir(nw["workdir"], model + "_synthetic",
                                        Q, B, k)
    dst = naming.setup_model_output_folder(root, model + "_synthetic", Q, B,
                                           k)
    for name in (naming.get_source_query_dataset_filename(src, model, Q, D),
                 naming.get_source_base_dataset_filename(src, model, B, D)):
        shutil.copy2(name, os.path.join(dst, os.path.basename(name)))
    argv = [str(Q), str(B), "-k", str(k), "-m", model, "--synthetic",
            "--yes", "--no-gen-hdf5", "--data-dir", root, "--mesh", "1"]
    _, secs["nw"] = counted_run(launches, "nw", sk.screen_keys,
                                lambda: nw_main(argv))
    files8 = nw["files"]
    files = naming.get_ivec_fvec_filenames(
        dst, naming.get_model_prefix(model), D, B, Q, k)
    mismatches = validate_files_v0(dst, *files)
    knn_agree(fvec.read_vectors(files[3]), fvec.read_vectors(files[2]),
              fvec.read_vectors(files8[3]), fvec.read_vectors(files8[2]),
              f"(b) nw --mesh 1 ivec vs phase 8's (validate_files_v0 "
              f"mismatches {mismatches})")
    if mismatches:
        raise AssertionError(f"validate_files_v0 found {mismatches}")
    require_wgmma(launches, "nw")
    log(f"  (b) seconds: compute_knn_ds(mesh) {secs['compute_knn_ds']:.2f} "
        f"(phase 4's compute_knn_ds {p4['stages']}), nw --mesh 1 "
        f"(generation skipped) {secs['nw']:.2f}; launches "
        f"{dict((n, launches[n]) for n in ('compute_knn_ds', 'nw'))}")


def mesh_maxsim(mrec, kept, mesh, secs):
    """(c): ShardedStreamingMaxSim over phase 6's corpus, then
    compute_maxsim_knn(mesh) over phase 7's parquet."""
    import pyarrow.parquet as pq
    import torch
    from neighborhoodwatch_tpu_torch.core.colbert_pipeline import (
        compute_maxsim_knn,
    )
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.ops import maxsim_kernel as mk
    from neighborhoodwatch_tpu_torch.parallel import sharded_maxsim as SM
    from neighborhoodwatch_tpu_torch.utils import naming
    launches = mrec["mesh_launches"]
    k = 100
    q, qm, d, dm = maxsim_corpus()
    tile = mk.MEGA_DOCS

    def stream():
        acc = SM.ShardedStreamingMaxSim(q, qm, k, mesh)
        for s in range(0, d.shape[0], tile):
            acc.update(d[s:s + tile], dm[s:s + tile])
        return acc.finalize() + (acc.escalated_tiles, acc.repaired_rows)
    (s_, i_, escalated, repaired), secs["sharded_streaming_maxsim"] = \
        counted_run(launches, "sharded_streaming_maxsim", mk.maxsim_keys,
                    stream)
    ref = kept["maxsim_stream"]
    maxsim_agree(s_, i_, ref["s"], ref["i"], k,
                 f"(c) ShardedStreamingMaxSim, {-(-d.shape[0] // tile)} "
                 f"tiles of {tile} docs, vs phase 6's StreamingMaxSim")
    require_wgmma(launches, "sharded_streaming_maxsim")
    del q, qm, d, dm
    torch.cuda.empty_cache()

    p7 = kept["ck"]
    files = p7["files"]
    idx7, dist7 = fvec.read_vectors(files[2]), fvec.read_vectors(files[3])
    _, secs["compute_maxsim_knn"] = counted_run(
        launches, "compute_maxsim_knn", mk.maxsim_keys,
        lambda: compute_maxsim_knn(p7["data_dir"], p7["qfile"], p7["bfile"],
                                   k=k, mesh=mesh))
    idx = pq.read_table(naming.get_partial_indices_filename(
        p7["data_dir"], -1)).to_pandas().values
    dist = pq.read_table(naming.get_partial_distances_filename(
        p7["data_dir"], -1)).to_pandas().values
    maxsim_agree(-dist, idx, -dist7, idx7, k,
                 "(c) compute_maxsim_knn(mesh) vs phase 7's exported "
                 "neighbours")
    require_wgmma(launches, "compute_maxsim_knn")
    log(f"  (c) seconds: ShardedStreamingMaxSim "
        f"{secs['sharded_streaming_maxsim']:.2f} (phase 6's StreamingMaxSim "
        f"{ref['seconds']:.2f}; {escalated} tiles escalated, {repaired} "
        f"query rows repaired exactly), compute_maxsim_knn(mesh) "
        f"{secs['compute_maxsim_knn']:.2f} (phase 7's whole ck run "
        f"{p7['seconds']:.1f}); launches {launches}")


def phase_mesh(rec, mrec, kept, workdir):
    """Phase 11: the scale-out layer (parallel/) at world size 1 over NCCL
    through (a)-(c), then (d) two gloo ranks on the card. Returns the
    seconds of each path."""
    import torch
    import torch.distributed as dist
    from neighborhoodwatch_tpu_torch.parallel.mesh import make_mesh
    rec["mesh_launches"], mrec["mesh_launches"] = {}, {}
    secs = {}
    mesh = make_mesh(1)
    try:
        if mesh.backend != "nccl" or mesh.stage:
            raise AssertionError(f"world size 1 on the card took "
                                 f"{mesh.backend}, staging {mesh.stage}")
        log(f"  world size 1: {mesh.backend} on {mesh.device}, mesh "
            f"{mesh.shape}")
        mesh_knn(rec, kept["engine"], mesh, secs)
        mesh_pipelines(rec, kept, mesh, secs)
        mesh_maxsim(mrec, kept, mesh, secs)
        # (d)'s world-size-1 reference, on the same seeded inputs
        reference = two_rank_paths(mesh, {})
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    secs["two_rank_wall"] = two_rank_run(workdir, reference, rec, mrec)
    rec["mesh_seconds"] = secs
    return secs


# ------------------------------------------------------------ phase 12


@contextlib.contextmanager
def fvec_codec(name):
    """The fvec codec of the wrapped region: "native" (the C++ engine) or
    "numpy" (NW_TPU_NATIVE=0, read by the engine at every call)."""
    from neighborhoodwatch_tpu_torch.io import fvec
    old = os.environ.pop("NW_TPU_NATIVE", None)
    if name == "numpy":
        os.environ["NW_TPU_NATIVE"] = "0"
    try:
        if fvec.codec() != name:
            raise AssertionError(f"asked for the {name} codec, got "
                                 f"{fvec.codec()}")
        yield
    finally:
        os.environ.pop("NW_TPU_NATIVE", None)
        if old is not None:
            os.environ["NW_TPU_NATIVE"] = old


def port_fvec(rec, q, base, workdir, n_base=250_000, n_q=1_000):
    """(a): phase 3's first 250,000 base rows and 1,000 queries written and
    read back by both codecs, byte for byte. Returns the native files."""
    from neighborhoodwatch_tpu_torch.io import fvec
    from neighborhoodwatch_tpu_torch.native import build
    with fvec_codec("native"):
        lib = build.library_path()
    B, Q = base[:n_base].cpu().numpy(), q[:n_q].cpu().numpy()
    secs, files = {}, {}
    for name in ("native", "numpy"):
        files[name] = (os.path.join(workdir, f"query_{name}.fvec"),
                       os.path.join(workdir, f"base_{name}.fvec"))
        with fvec_codec(name):
            fvec.write_vectors(files[name][0], Q)
            t = time.perf_counter()
            fvec.write_vectors(files[name][1], B)
            secs[f"write_{name}"] = time.perf_counter() - t
    for i in (0, 1):
        if not filecmp.cmp(files["native"][i], files["numpy"][i],
                           shallow=False):
            raise AssertionError(f"the codecs wrote different bytes: "
                                 f"{files['native'][i]}")
    # the files were just written: both reads come from the page cache.
    # Timed to contiguous arrays, the form a copy to the card reads (the
    # numpy codec returns a strided view past the row headers, the native
    # engine contiguous rows)
    for name in ("native", "numpy", "numpy", "native"):
        with fvec_codec(name):
            t = time.perf_counter()
            got = np.ascontiguousarray(fvec.read_vectors(files["native"][1]))
            secs.setdefault(f"read_{name}", []).append(
                time.perf_counter() - t)
            if not np.array_equal(got, B):
                raise AssertionError(f"the {name} codec read other values")
            t = time.perf_counter()
            n = sum(len(np.ascontiguousarray(b)) for _, b in
                    fvec.iter_vector_batches(files["native"][1], 100_000))
            secs.setdefault(f"stream_{name}", []).append(
                time.perf_counter() - t)
            if n != n_base:
                raise AssertionError(f"the {name} stream gave {n} rows")
        del got
    gb = os.path.getsize(files["native"][1]) / 1e9
    log(f"  (a) {n_base:,} x {B.shape[1]} base ({gb:.2f} GB) and {n_q:,} "
        f"queries: native engine {os.path.basename(lib)}; bytes equal; "
        f"write native {secs['write_native']:.2f} s, numpy "
        f"{secs['write_numpy']:.2f} s; read to contiguous arrays (page "
        f"cache, in turns) native "
        f"{np.mean(secs['read_native']):.3f} s, numpy "
        f"{np.mean(secs['read_numpy']):.3f} s; stream alone (100,000-row "
        f"batches) native {np.mean(secs['stream_native']):.3f} s, numpy "
        f"{np.mean(secs['stream_numpy']):.3f} s")
    rec["fvec_codec_seconds"] = {
        key: float(np.mean(v)) for key, v in secs.items()}
    return files["native"]


def port_tools(rec, files, workdir, k=100):
    """(b): nw-tools knn --batch-rows 100000 over (a)'s files, native stream
    and numpy codec in turns after an untimed first run; the ivecs and
    distances must be equal."""
    from neighborhoodwatch_tpu_torch import tools
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    launches, secs, outs = {}, {}, {}
    for turn, name in enumerate(("numpy", "native", "numpy", "numpy",
                                 "native")):
        out_dir = os.path.join(workdir, f"tools_{turn}")
        os.makedirs(out_dir)
        tee = Tee(sys.stdout)
        with fvec_codec(name), contextlib.redirect_stdout(tee):
            _, wall = counted_run(launches, f"{name}_{turn}", sk.screen_keys,
                                  lambda: tools.main([
                                      "knn", files[0], files[1], "-k",
                                      str(k), "--batch-rows", "100000",
                                      "--out-dir", out_dir]))
        if turn:
            secs.setdefault(name, []).append(wall)
        by = launches[f"{name}_{turn}"]
        # batches of 100,000, 100,000 and 50,000 rows: the last is below
        # two mega-tiles and takes the verified engine
        if by["wgmma"] != 2 or by["mma"]:
            raise AssertionError(f"nw-tools knn ({name}) launched {by}")
        report = json.loads(tee.kept.getvalue().strip().splitlines()[-1])
        outs[turn] = (report["indices"], report["distances"])
    for turn in (1, 2, 3, 4):
        for i in (0, 1):
            if not filecmp.cmp(outs[0][i], outs[turn][i], shallow=False):
                raise AssertionError(f"nw-tools knn wrote other results "
                                     f"in turn {turn}: {outs[turn][i]}")
    log(f"  (b) nw-tools knn --batch-rows 100000, 1,000 queries x 250,000 "
        f"rows from the page cache, in turns: native stream "
        f"{secs['native'][0]:.2f} / {secs['native'][1]:.2f} s, numpy "
        f"{secs['numpy'][0]:.2f} / {secs['numpy'][1]:.2f} s; ivec and "
        f"distances equal in all 5 runs; kernel launches per run "
        f"{launches['native_1']}")
    rec["port_launches"]["nw_tools_knn_native"] = launches["native_1"]
    rec["port_launches"]["nw_tools_knn_numpy"] = launches["numpy_2"]
    rec["nw_tools_knn_seconds"] = {n: float(np.mean(v))
                                   for n, v in secs.items()}


def port_screened(rec, q, base, ref, k=100):
    """(c): the host-repair engine at phase 3's shapes against phase 3's
    knn()."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    real, rescanned = K._knn_scan, []

    def counted_scan(query, *a, **kw):
        rescanned.append(query.shape[0])
        return real(query, *a, **kw)
    K._knn_scan = counted_scan
    try:
        (d, i), first = counted_run(rec["port_launches"], "screened_knn",
                                    sk.screen_keys,
                                    lambda: K.screened_knn(q, base, k))
    finally:
        K._knn_scan = real
    by = rec["port_launches"]["screened_knn"]
    if by["wgmma"] != 1 or by["mma"]:
        raise AssertionError(f"screened_knn launched {by}")
    ms = median_ms(lambda: K.screened_knn(q, base, k))
    log(f"  (c) screened_knn {q.shape[0]:,} x {base.shape[0]:,} x "
        f"{base.shape[1]}, k={k}: launches {by}, first call {first:.3f} s, "
        f"median of 3 {ms:.1f} ms (phase 3's knn() {ref['median_ms']:.1f} "
        f"ms); rows rescanned on the host {sum(rescanned)}")
    knn_agree(d, i, ref["d"], ref["i"], "(c) screened_knn vs phase 3's knn()")
    rec["screened_knn_ms"] = ms
    rec["screened_knn_rescanned"] = int(sum(rescanned))
    del d, i
    torch.cuda.empty_cache()


def port_probe(arec):
    """(d): the encoder probe's rows; "flash" must launch the "wgmma"
    attention kernel once a layer a forward, "auto" never."""
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    from neighborhoodwatch_tpu_torch.probes import encoder_probe as ep
    iters = 3
    reset_counts(ak.masked_attention)
    rows = ep.run(iters=iters)
    by = dict(ak.masked_attention.launches_by_variant)
    for r in rows:
        want = 0 if r["impl"] == "auto" else \
            ep.E5_CONFIGS[r["model"]].num_layers * (iters + 1)
        if r["launches"] != want:
            raise AssertionError(f"probe row {r}: {want} launches expected")
    if by["mma"] or by["wgmma"] != sum(r["launches"] for r in rows):
        raise AssertionError(f"the probe launched {by}")
    arec["probe_launches"] = by
    arec["probe"] = rows


def phase_port(rec, arec, ref, workdir):
    """Phase 12: the native fvec engine (a), nw-tools knn over its stream
    (b), screened_knn (c) and the encoder probe (d)."""
    import torch
    rec["port_launches"] = {}
    q, base = engine_data()
    files = port_fvec(rec, q, base, workdir)
    port_tools(rec, files, workdir)
    port_screened(rec, q, base, ref)
    del q, base
    torch.cuda.empty_cache()
    port_probe(arec)


# ------------------------------------------------------------ phase 13


def verified_tiles():
    """Phase 13(a)'s fp32 distance tiles on the card, from unit Gaussian
    rows at 1536 dims: {name: (Q, N) tile}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops.distance import pairwise_distance
    g = torch.Generator(device="cuda").manual_seed(13)
    q = unit_rows(1000, 1536, g)
    b = unit_rows(32768, 1536, g)
    # every base row three times over: exact ties at and around the k-th
    tripled = b[:2731].repeat(3, 1)[:8192]
    tiles = {"1000x8192": pairwise_distance(q, b[:8192]),
             "128x32768": pairwise_distance(q[:128], b),
             "512x8192_ties": pairwise_distance(q[:512], tripled)}
    # the escalation's tile of few wide rows
    wide = unit_rows(262144, 1536, g)
    tiles["16x262144"] = pairwise_distance(q[:16], wide)
    return tiles


def per_call_ms(fn):
    """Milliseconds of one call of `fn` by CUDA events around REPS calls
    back to back, after one untimed call."""
    fn()
    return event_ms(lambda: [fn() for _ in range(REPS)]) / REPS


def graph_ms(fn):
    """Milliseconds of one call of `fn` on the card alone: REPS calls
    captured in a CUDA graph, its replay timed by CUDA events (median of
    3), so that no host time lies between the calls."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    graph.replay()
    ms = event_ms(graph.replay) / REPS
    del graph
    return ms


def rotating_ms(fn, inputs, graph=True):
    """Milliseconds of one call of `fn`, each call on its own input of
    `inputs` and with its own output kept, so that a caller who makes the
    inputs and outputs together well larger than the L2 cache times calls
    that read their input from HBM: all of them captured in one CUDA graph
    and its replay timed by CUDA events (median of 3; the card alone, as
    graph_ms), or with graph=False back to back through the host."""
    import torch
    fn(inputs[0])
    if not graph:
        return event_ms(lambda: [fn(x) for x in inputs]) / len(inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured, capture_error_mode="relaxed"):
        outs = [fn(x) for x in inputs]
    captured.replay()
    ms = event_ms(captured.replay) / len(inputs)
    del captured, outs
    return ms


def select_bound_ms(q_rows, n, k):
    """One read of the tile, one write of (dist f32, position int64) and of
    the proof's byte per row, at the card's memory rate."""
    return (q_rows * n * 4 + q_rows * k * 12 + q_rows) / PEAK_BYTES * 1e3


def verified_path(vk, variant):
    """The path the last launch took: "radix", or the "adaptive" plan's
    path, cluster size and where its keys live."""
    if variant == "radix":
        return "radix"
    pl, active = vk.verified_select.last_plan
    return (f"{pl.path} C={pl.cluster} {pl.clusters} clusters (card holds "
            f"{active}), keys in {pl.keys_in}, {pl.buffers} buffers, "
            f"{pl.smem_bytes} B")


def verified_check(vk, d, k, want, name, exclude=-1):
    """Both variants on tile `d` against `want` (the plain version's
    result): positions equal, distances equal bit for bit, proof verdicts
    equal, and the rows that fell back (all of them when a column is
    excluded, else none). Returns ({variant: path}, the largest |distance
    - plain| over both variants)."""
    import torch
    paths, err = {}, 0.0
    for variant in vk.VARIANTS:
        vk.reset_failed_rows()
        with vk.forced_variant(variant):
            got = vk.verified_select(d, k, exclude=exclude)
        torch.cuda.synchronize()
        failed = vk.failed_rows()
        paths[variant] = verified_path(vk, variant)
        diff = (got[0] - want[0]).abs().nan_to_num(0.0)
        err = max(err, float(diff.max()))
        same_i = torch.equal(got[1], want[1])
        same_d = torch.equal(got[0].view(torch.int32),
                             want[0].view(torch.int32))
        same_ok = torch.equal(got[2], want[2])
        same = same_i and same_d and same_ok
        expected = d.shape[0] if exclude >= 0 else 0
        if not same or failed != expected:
            raise AssertionError(
                f"verified_select [{variant}] {name} k={k} exclude="
                f"{exclude}: positions equal {same_i}, distances bit-equal "
                f"{same_d}, proof verdicts equal {same_ok}, "
                f"{failed} rows fell back ({expected} expected); path "
                f"{paths[variant]}")
    return paths, err


def verified_vs_plain(tiles):
    """(a): both variants against the plain version on every tile and k,
    bit for bit; the variants timed in turns (radix, adaptive, adaptive,
    radix) beside the plain version, torch.topk, the exact engine's stable
    sort and the bytes bound; then a planted candidate set on every path.
    Returns {case: {k: numbers}}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
    from neighborhoodwatch_tpu_torch.ops.topk import smallest_k
    out = {}
    for name, d in tiles.items():
        q_rows, n = d.shape
        for k in (1, 100, 1024):
            want = vk.verified_select_plain(d, k)
            if not bool(want[2].all()):
                raise AssertionError(f"plain {name} k={k}: the proof failed")
            paths, err = verified_check(vk, d, k, want, name)
            # the card's time of each variant in turns, and of one call
            # through the wrapper (the host's share included)
            turns = {v: [] for v in vk.VARIANTS}
            call = {}
            for variant in ("radix", "adaptive", "adaptive", "radix"):
                with vk.forced_variant(variant):
                    turns[variant].append(
                        graph_ms(lambda: vk.verified_select(d, k)))
                    call.setdefault(variant, per_call_ms(
                        lambda: vk.verified_select(d, k)))
            ms = float(np.mean(turns["adaptive"]))
            before = float(np.mean(turns["radix"]))
            plain_ms = event_ms(lambda: vk.verified_select_plain(d, k))
            topk_ms = graph_ms(lambda: torch.topk(d, k, largest=False))
            sort_ms = graph_ms(lambda: smallest_k(d, k))
            bound = select_bound_ms(q_rows, n, k)
            out.setdefault(name, {})[str(k)] = {
                "ms": ms, "before_ms": before, "turns_ms": turns,
                "call_ms": call, "plain_ms": plain_ms,
                "library_ms": topk_ms, "sort_ms": sort_ms,
                "bound_ms": bound, "max_abs_err": err, "failed_rows": 0,
                "path": paths["adaptive"]}
            log(f"  (a) {name} k={k}: adaptive {ms:.4f} ms "
                f"({ms / bound:.2f}x the bytes bound {bound:.4f} ms; "
                f"{ms / topk_ms:.2f}x torch.topk {topk_ms:.4f} ms), radix "
                f"{before:.4f} ms ({before / bound:.2f}x), turns (radix, "
                f"adaptive, adaptive, radix) {turns['radix'][0]:.4f} / "
                f"{turns['adaptive'][0]:.4f} / {turns['adaptive'][1]:.4f} / "
                f"{turns['radix'][1]:.4f}; one call through the wrapper "
                f"(host included) radix {call['radix']:.4f} / adaptive "
                f"{call['adaptive']:.4f} ms; stable sort (the exact select) "
                f"{sort_ms:.4f} ms, plain {plain_ms:.3f} ms; both variants "
                f"equal the plain version bit for bit, no row fell back; "
                f"path {paths['adaptive']}")
    # a planted candidate set on every path: column 0 holds every row's
    # minimum and is dropped from the candidates, so every row must fail
    # and fall back to the exact selection
    for name in ("1000x8192", "128x32768", "16x262144"):
        d = tiles[name].clone()
        d[:, 0] = -1.0
        want_d, want_i = smallest_k(d, 100)
        want = (want_d, want_i, torch.zeros(d.shape[0], dtype=torch.bool,
                                            device=d.device))
        paths, _ = verified_check(vk, d, 100, want, name, exclude=0)
        log(f"  (a) planted candidate set ({name}, k=100, column 0 "
            f"dropped): every row failed the proof and was selected again "
            f"exactly in the kernel, on both variants; adaptive path "
            f"{paths['adaptive']}")
        del d
    return out


def verified_engine(rec, n_q=512, k=100):
    """(b) and (d): knn(engine="verified") against "exact" at phase 3's
    data on `n_q` queries, the exact engine with torch.topk as its select,
    and the exact engine at precision "default" and "high"."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
    q, base = engine_data()
    q = q[:n_q].contiguous()
    B, D = base.shape
    with fused_counted("engine_exact"):
        d_e, i_e = K.knn(q, base, k, engine="exact")
    vk.reset_failed_rows()
    with verified_counted("engine_verified"), \
            fused_counted("engine_verified"):
        d_v, i_v = K.knn(q, base, k, engine="verified")
    torch.cuda.synchronize()
    # each tile's product and epilogue on F4, the base's norms once on F1
    for path in ("engine_exact", "engine_verified"):
        require_fused(path, ("prepare_base", "split_distance"))
    knn_agree(d_v, i_v, d_e, i_e, f"(b) knn(engine='verified') vs 'exact', "
              f"{n_q} x {B} x {D}, k={k}")
    exact_ms = median_ms(lambda: K.knn(q, base, k, engine="exact"))
    verified_ms = median_ms(lambda: K.knn(q, base, k, engine="verified"))

    def topk_select(d, kk):
        return torch.topk(d, kk, largest=False)
    real = K._select
    K._select = lambda engine: topk_select
    try:
        d_t, i_t = K.knn(q, base, k, engine="exact")
        topk_ms = median_ms(lambda: K.knn(q, base, k, engine="exact"))
    finally:
        K._select = real
    knn_agree(d_t, i_t, d_e, i_e, "(b) the exact engine with torch.topk as "
              "its select vs 'exact'")
    flops = 2.0 * n_q * B * D
    bytes_ = (n_q + B) * D * 4 + n_q * k * 8
    bound = max(flops / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES) * 1e3
    tiles = VERIFIED_LAUNCHES["engine_verified"]
    log(f"  (b) medians of 3: exact (stable sort per tile) {exact_ms:.1f} ms, "
        f"verified (K7 per tile, {tiles} launches, {vk.failed_rows()} rows "
        f"fell back) {verified_ms:.1f} ms, exact with torch.topk "
        f"{topk_ms:.1f} ms; bound (the fp32 product at "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s) {bound:.1f} ms; fused "
        f"kernels exact {FUSED_LAUNCHES['engine_exact']}, verified "
        f"{FUSED_LAUNCHES['engine_verified']}")
    rec["engine"] = {"Q": n_q, "B": B, "D": D, "k": k, "exact_ms": exact_ms,
                     "verified_ms": verified_ms, "topk_ms": topk_ms,
                     "bound_ms": bound, "launches": tiles}
    prec = {}
    for p in ("default", "high"):
        d_p, i_p = K.knn(q, base, k, engine="exact", precision=p)
        ms = median_ms(lambda p=p: K.knn(q, base, k, engine="exact",
                                         precision=p))
        err = float((d_p - d_e).abs().max())
        same = float((i_p == i_e).float().mean())
        prec[p] = {"ms": ms, "max_abs_d_vs_highest": err,
                   "identical_positions": same}
        log(f"  (d) precision {p!r}, exact engine at (b)'s shape: {ms:.1f} "
            f"ms (highest {exact_ms:.1f} ms), max |d - d_highest| "
            f"{err:.3g}, identical positions {same:.5f}")
    rec["precision"] = prec
    del q, base, d_e, i_e, d_v, i_v, d_t, i_t
    torch.cuda.empty_cache()


def nw_embeddings(nw):
    """Phase 8's query and base embeddings, on the card."""
    import torch
    from neighborhoodwatch_tpu_torch.io.parquet_io import read_embeddings
    from neighborhoodwatch_tpu_torch.utils import naming
    Q, B, D, k, model = nw["Q"], nw["B"], nw["D"], nw["k"], nw["model"]
    data_dir = naming.get_model_data_homedir(nw["workdir"],
                                             model + "_synthetic", Q, B, k)
    qfile = naming.get_source_query_dataset_filename(data_dir, model, Q, D)
    bfile = naming.get_source_base_dataset_filename(data_dir, model, B, D)
    q = torch.as_tensor(read_embeddings(data_dir, qfile, Q, D), device="cuda")
    base = torch.as_tensor(read_embeddings(data_dir, bfile, B, D),
                           device="cuda")
    return q, base


def verified_nw_batch(rec, nw):
    """(c): phase 8's screened kNN call with its exact fallback on the
    stable sort ("exact") and on K7 ("verified"), in turns, and K7's
    launches of one call."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import verified_kernel as vk
    Q, B, D, k = nw["Q"], nw["B"], nw["D"], nw["k"]
    q, base = nw_embeddings(nw)

    def call():
        return K.screened_knn_traced(q, base, B, 0, k, "sqeuclidean",
                                     with_diagnostics=True)
    real = K._fallback_engine
    got, ms = {}, {"exact": [], "verified": []}
    try:
        for name in ("exact", "verified", "verified", "exact"):
            K._fallback_engine = lambda device, name=name: name
            got[name] = call()
            ms[name].append(median_ms(call))
    finally:
        K._fallback_engine = real
    vk.reset_failed_rows()
    reset_counts(vk.verified_select)
    torch.cuda.synchronize()
    with fused_counted("nw_batch"):
        d, i, diag = call()
        torch.cuda.synchronize()
    launches = vk.verified_select.launches
    failed = vk.failed_rows()
    if launches < 1:
        raise AssertionError("the screened call's fallback never launched "
                             "the verified select")
    knn_agree(d, i, got["exact"][0], got["exact"][1],
              "(c) fallback on K7 vs on the stable sort")
    before, after = float(np.mean(ms["exact"])), float(np.mean(ms["verified"]))
    log(f"  (c) nw's screened call {Q} x {B} x {D}, k={k} (class-A "
        f"{diag[0]}, class-B {diag[1]}, whole-batch fallback {diag[2]}), "
        f"medians of 3 in turns (exact, verified, verified, exact): fallback "
        f"on the stable sort {ms['exact'][0]:.2f} / {ms['exact'][1]:.2f} ms, "
        f"on K7 {ms['verified'][0]:.2f} / {ms['verified'][1]:.2f} ms; K7 "
        f"launches of the call {launches}, rows fallen back {failed}; fused "
        f"kernels {FUSED_LAUNCHES['nw_batch']}")
    rec["nw_batch"] = {"Q": Q, "B": B, "D": D, "k": k, "ms_before": before,
                       "ms": after, "launches": launches,
                       "repairs": list(diag)}
    del q, base, got, d, i
    torch.cuda.empty_cache()


def phase_verified(rec, nw):
    """Phase 13: the verified select K7 against its plain version (a), the
    verified engine (b) and the precisions (d) at phase 3's shape, and
    phase 8's screened call with its fallback on K7 (c). The kernel's
    main-path count is phase 8's: nw_main's launches."""
    import torch
    tiles = verified_tiles()
    shapes = verified_vs_plain(tiles)
    del tiles
    torch.cuda.empty_cache()
    verified_engine(rec)
    verified_nw_batch(rec, nw)
    # the main path: phase 8's nw_main, whose screened call falls back on
    # K7 for every query that fails the certificate, on the default variant
    launches = VERIFIED_LAUNCHES["nw"]
    by_variant = VERIFIED_BY_VARIANT["nw"]
    if launches < 1 or by_variant["adaptive"] != launches:
        raise AssertionError(f"nw_main launched the verified select "
                             f"{launches} times, by variant {by_variant}")
    main = shapes["1000x8192"]["100"]
    rec.update(variant="adaptive", launches=launches,
               launches_by_variant=by_variant, max_abs_err=max(
                   v["max_abs_err"] for case in shapes.values()
                   for v in case.values()),
               ms=main["ms"], before_ms=main["before_ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by="bytes", library_ms=main["library_ms"],
               sort_ms=main["sort_ms"], shapes=shapes,
               launches_by_path=dict(VERIFIED_LAUNCHES),
               launches_by_path_variant=dict(VERIFIED_BY_VARIANT))
    log(f"  K7 launches by path (each counted from 0): {VERIFIED_LAUNCHES}; "
        f"by variant {VERIFIED_BY_VARIANT}")


# ------------------------------------------------------------ phase 14


def base_texts(n, seed=0):
    """The first n sentences of nw's synthetic base source, sentencized as
    nw does (one 12-word sentence a row: 19 hash tokens, bucket 32)."""
    from neighborhoodwatch_tpu_torch.data.sources import (
        split_into_sentences, synthetic_dataset,
    )
    rows = synthetic_dataset("document", n, seed=seed)
    return [s for r in rows for s in split_into_sentences(r["text"])][:n]


@contextlib.contextmanager
def host_split(gen, encode="_encode"):
    """Host seconds of a generator's encode loop by part, filled into the
    yielded dict on exit: "tokenize" (the tokenizer's calls), "launch"
    (the model's forward calls where it runs op by op, the CUDA graphs'
    replays where it replays) and "copy" (the rest of each batch's
    `encode` method: the input copies, which wait for the card where they
    synchronize, padding, pooling's launches and the output's copy)."""
    import torch
    got = {"tokenize": 0.0, "launch": 0.0, "copy": 0.0, "encode": 0.0}
    tok, enc = gen.tokenizer, getattr(gen, encode)
    replay = torch.cuda.CUDAGraph.replay
    starts = []

    def timed(fn, key):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                got[key] += time.perf_counter() - t
        return call

    def pre(*_):
        starts.append(time.perf_counter())

    def post(*_):
        got["launch"] += time.perf_counter() - starts.pop()
    hooks = [gen.model.register_forward_pre_hook(pre),
             gen.model.register_forward_hook(post)]
    gen.tokenizer = timed(tok, "tokenize")
    setattr(gen, encode, timed(enc, "encode"))
    torch.cuda.CUDAGraph.replay = timed(replay, "launch")
    try:
        yield got
    finally:
        gen.tokenizer = tok
        setattr(gen, encode, enc)
        torch.cuda.CUDAGraph.replay = replay
        for h in hooks:
            h.remove()
        got["copy"] = got["encode"] - got["tokenize"] - got["launch"]


def trace_busy(trace_file, region):
    """From a Chrome trace of utils/profiling.py:device_trace: the span of
    the user annotation `region` on the host's clock (ms), the card's busy
    ms inside it (the union of its kernel, memcpy and memset intervals)
    and the kernels that started inside it ({name: launches})."""
    with open(trace_file) as f:
        events = json.load(f).get("traceEvents", [])
    span = next(e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == region)
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and e["ts"] < t1 and e["ts"] + e.get("dur", 0) > t0)
    busy, end = 0.0, t0
    for a, b in device:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel" and t0 <= e["ts"] < t1:
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return (t1 - t0) / 1e3, busy / 1e3, kernels


def encoder_kernel(name, kernel):
    """Whether a trace's kernel name is one of E1-E3's kernels `name` (the
    "rowpass" `<name>_kernel`, or the "staged" `<name>_staged`)."""
    return f"{name}_kernel" in kernel or f"{name}_staged" in kernel


def trace_share(trace_dir, forwards):
    """{idle_share, busy / traced ms a forward, kernels a forward, E1-E3's
    kernels a forward, the ATen softmax and layer_norm kernels left} of
    the "encode_loop" region of the newest trace in `trace_dir` (removed
    after), or {"idle_share": "not measured"} without a trace."""
    trace_file = trace_top_kernels(trace_dir)[0]
    if trace_file is None:
        return {"idle_share": "not measured"}
    span, busy, kernels = trace_busy(trace_file, "encode_loop")
    shutil.rmtree(trace_dir, ignore_errors=True)
    ours = {n: sum(c for k, c in kernels.items() if encoder_kernel(n, k))
            for n in ENCODER_KERNELS}
    aten = sorted(k[:100] for k in kernels if ATEN_NORM_SOFTMAX.search(k)
                  and not any(encoder_kernel(n, k) for n in ENCODER_KERNELS))
    return {"idle_share": 1 - busy / span, "traced_forwards": forwards,
            "traced_ms_per_forward": span / forwards,
            "busy_ms_per_forward": busy / forwards,
            "kernels_per_forward": sum(kernels.values()) / forwards,
            "fused_kernels_per_forward": {n: c / forwards
                                          for n, c in ours.items()},
            "aten_norm_softmax_kernels": aten}


def share_text(tr):
    if tr["idle_share"] == "not measured":
        return "device idle share not measured (no trace)"
    return (f"device idle share {tr['idle_share']:.4f}, busy "
            f"{tr['busy_ms_per_forward']:.3f} ms of "
            f"{tr['traced_ms_per_forward']:.3f} ms a forward, "
            f"{tr['kernels_per_forward']:.1f} kernels a forward (E1-E3 "
            f"{[round(v, 2) for v in tr['fused_kernels_per_forward'].values()]}"
            f"; ATen softmax / layer_norm kernels "
            f"{tr['aten_norm_softmax_kernels'] or 'none'})")


def encoder_loop(gen, calls, workdir, label, traced):
    """A generator's generate_embedding over `calls` (lists of texts, one
    call each: nw's base set calls the e5 generator with 10,000 sentences,
    ck's source loop the ColBERT generator with one passage): once untimed
    (every shape seen), once timed on the host clock with the host split
    (host_split), and over the calls `traced` once under device_trace, for
    the card's idle share and kernels a forward. Returns the numbers as a
    dict."""
    import torch
    from neighborhoodwatch_tpu_torch.utils.profiling import device_trace
    encode = "_encode" if hasattr(gen, "_encode") else "encode_passages"

    def forwards(cs):
        return sum(-(-len(c) // 64) for c in cs)

    def run(cs):
        for c in cs:
            gen.generate_embedding(c)
    run(calls)
    seen = gen.tokens_seen
    with host_split(gen, encode) as split:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(calls)
        wall = time.perf_counter() - t
    tokens = gen.tokens_seen - seen
    n = forwards(calls)
    trace_dir = os.path.join(workdir, f"encoder_trace_{label}")
    with device_trace(trace_dir):
        with torch.profiler.record_function("encode_loop"):
            run(traced)
    out = {"texts": sum(len(c) for c in calls), "calls": len(calls),
           "forwards": n, "wall_s": wall, "tokens_per_s": tokens / wall,
           "host_ms_per_forward": wall * 1e3 / n,
           **{f"{k}_ms_per_forward": v * 1e3 / n
              for k, v in split.items() if k != "encode"},
           **trace_share(trace_dir, forwards(traced))}
    log(f"  encode loop [{label}]: {out['texts']} texts in {len(calls)} "
        f"calls, {n} forwards in {wall:.2f} s ({out['tokens_per_s']:.0f} "
        f"tokens/s, {out['host_ms_per_forward']:.3f} ms a forward on the "
        f"host: tokenize {out['tokenize_ms_per_forward']:.3f}, launch "
        f"{out['launch_ms_per_forward']:.3f}, copy and the rest "
        f"{out['copy_ms_per_forward']:.3f}); traced over "
        f"{forwards(traced)} forwards: {share_text(out)}")
    return out


@contextlib.contextmanager
def graph_forwards():
    """The graph runner's counts set to 0 for the region (forwards by
    variant, captures); yields a dict filled on exit with them and every
    runner made in the region: its name, captured shapes and bound."""
    from neighborhoodwatch_tpu_torch.models import graphed
    G = graphed.GraphRunner
    G.launches, G.captures = 0, 0
    G.launches_by_variant = {v: 0 for v in graphed.VARIANTS}
    made, init = [], G.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)
    G.__init__ = record
    got = {}
    try:
        yield got
    finally:
        G.__init__ = init
        got.update(forwards=G.launches, by_variant=dict(G.launches_by_variant),
                   captures=G.captures,
                   runners=[{"name": r.name, "shapes": sorted(r.graphs),
                             "bound": r.max_graphs} for r in made])


def require_graphed(got, what):
    """Every forward of the region a graph replay, each runner's graphs
    within its bound."""
    by = got["by_variant"]
    if by["eager"] or by["graph"] < 1 or by["graph"] != got["forwards"]:
        raise AssertionError(f"{what}: forwards by variant {by}; every "
                             f"forward must be a graph replay")
    for r in got["runners"]:
        if len(r["shapes"]) > r["bound"]:
            raise AssertionError(f"{what}: {r}: graphs above the bound")
    log(f"  {what}: {got['forwards']} forwards, all graph replays; "
        f"captures {got['captures']} (" + "; ".join(
            f"{r['name']}: {r['shapes']} of at most {r['bound']}"
            for r in got["runners"]) + ")")


@contextlib.contextmanager
def traced_window(cls, first, count, trace_dir):
    """Calls first .. first + count - 1 of cls.generate_embedding made in
    the region (counted from 1) run under device_trace, as one
    "encode_loop" user annotation; the yielded dict gets the window's
    texts and forwards."""
    import torch
    from neighborhoodwatch_tpu_torch.utils.profiling import device_trace
    real = cls.generate_embedding
    state = {"n": 0, "texts": 0, "forwards": 0, "open": None}

    def close():
        region, trace = state["open"]
        state["open"] = None
        region.__exit__(None, None, None)
        trace.__exit__(None, None, None)

    def call(self, texts, *a, **kw):
        state["n"] += 1
        if state["n"] == first:
            trace = device_trace(trace_dir)
            trace.__enter__()
            region = torch.profiler.record_function("encode_loop")
            region.__enter__()
            state["open"] = (region, trace)
        try:
            return real(self, texts, *a, **kw)
        finally:
            if state["open"]:
                n = 1 if isinstance(texts, str) else len(texts)
                state["texts"] += n
                state["forwards"] += -(-n // 64)
                if state["n"] == first + count - 1:
                    close()
    cls.generate_embedding = call
    try:
        yield state
    finally:
        cls.generate_embedding = real
        if state["open"]:
            close()


@contextlib.contextmanager
def no_sync_before_readback():
    """torch.cuda.set_sync_debug_mode("error") around the region, lifted
    only inside Tensor.cpu (the generators' readback): any other call that
    synchronizes the stream raises."""
    import torch
    real = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    torch.Tensor.cpu = cpu
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.Tensor.cpu = real


def forward_flops(cfg, rows, T, head=0):
    """Matmul FLOPs of one BERT forward at (rows, T): a layer's four h x h
    projections and two FFN products, QK^T and PV over T x T; and a
    `head`-wide projection of every token (ColBERT's 128)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    layer = 2 * rows * T * (4 * h * h + 2 * h * f) + 4 * rows * T * T * h
    return cfg.num_layers * layer + 2 * rows * T * h * head


def forward_turns(runner, ids, mask, rows):
    """The runner's forward at one padded shape, "eager" and "graph" in
    turns (eager, graph, graph, eager): host ms a forward over REPS
    forwards ending in a synchronize, and device ms of one forward by CUDA
    events (the card idle before it), each a median of 3; the mean of each
    variant's two. The graph is captured before."""
    import torch
    from neighborhoodwatch_tpu_torch.models import graphed
    got = {"eager": [], "graph": []}

    def fwd():
        return runner(ids, mask, rows)

    def host():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REPS):
            fwd()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / REPS

    for name in ("eager", "graph", "graph", "eager"):
        with graphed.forced_variant(name):
            fwd()
            h = float(np.median([host() for _ in range(3)]))
            got[name].append((h, event_ms(fwd)))
    return {name: tuple(float(np.mean(x)) for x in zip(*v))
            for name, v in got.items()}


def plain_chain_turns(label, runner, ids, mask, rows, compared):
    """Phase 14(b): the forward at one padded shape on E1-E3 against the
    plain chain they replace (a second runner whose graph is captured
    under encoder_fused.forced_variant("plain")): the outputs' rows that
    `compared(out)` keeps against each other (bf16 through every layer, E2's
    one-ulp roundings carried along: max |d| <= 5e-2, cosine >= 0.999); the
    default variants (the runner's own graph: E1 and E2 "rowpass", E3
    "staged") against "rowpass" alone (a third runner captured under
    forced_variant("rowpass")): the outputs bit for bit; device ms a
    forward by CUDA events in turns (plain, rowpass, default, default,
    rowpass, plain)."""
    import torch
    from neighborhoodwatch_tpu_torch.models import graphed
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    plain = graphed.GraphRunner(runner.fn, runner.device, 1,
                                name=f"{runner.name} plain chain")
    with ef.forced_variant("plain"):
        want = plain(ids, mask, rows)           # captured op by op
    rowpass = graphed.GraphRunner(runner.fn, runner.device, 1,
                                  name=f"{runner.name} rowpass")
    with ef.forced_variant("rowpass"):
        first = rowpass(ids, mask, rows)        # captured on "rowpass"
    got = runner(ids, mask, rows)
    if not torch.equal(got, first):
        raise AssertionError(f"{label}: the forward on the defaults and on "
                             f"'rowpass' differ: max |d| "
                             f"{float((got - first).abs().max())}")
    d, cos = embeddings_agree(compared(got).float().cpu(),
                              compared(want).float().cpu())
    if d > 5e-2 or cos < 0.999:
        raise AssertionError(f"{label}: the forward on E1-E3 and on the "
                             f"plain chain differ: max |d| {d:.3g}, least "
                             f"cosine {cos:.6f}")
    t = in_turns({"plain": lambda: plain(ids, mask, rows),
                  "rowpass": lambda: rowpass(ids, mask, rows),
                  "default": lambda: runner(ids, mask, rows)}, event_ms)
    del plain, rowpass, want, first
    torch.cuda.empty_cache()
    log(f"      {label} {tuple(ids.shape)}: device ms a forward on E1-E3 "
        f"the defaults {t['default']:.3f}, 'rowpass' {t['rowpass']:.3f} (equal "
        f"bit for bit), on the plain chain {t['plain']:.3f} (graphs, in "
        f"turns); max |d| {d:.3g}, least cosine {cos:.6f}")
    return {"fused_device_ms": t["default"],
            "rowpass_device_ms": t["rowpass"],
            "plain_chain_device_ms": t["plain"],
            "fused_vs_plain_max_abs": d, "fused_vs_plain_cos": cos}


def shape_case(label, runner, ids, mask, rows, flops, cut_rows=None,
               layers=None, e3=True, compared=None):
    """Phase 14(b) at one padded shape through `runner`: the graph against
    the eager forward bit for bit, the padded forward against the unpadded
    one (cut_rows(out) gives the rows to compare and their unpadded
    reference), and both timed in turns beside the tensor-core bound; E1-E3
    launched per replay as a forward of `layers` layers launches them (E3
    none where K6 runs: `e3` False); with `compared`, the forward against
    the plain chain (plain_chain_turns)."""
    import torch
    from neighborhoodwatch_tpu_torch.models import graphed
    graph = runner(ids, mask, rows)
    with graphed.forced_variant("eager"):
        eager = runner(ids, mask, rows)
    if not torch.equal(graph, eager):
        raise AssertionError(f"{label}: graph and eager forwards differ: "
                             f"max |d| {float((graph - eager).abs().max())}")
    r = {"shape": list(ids.shape), "rows": rows, "graph_out": graph}
    if cut_rows is not None:
        a, b = cut_rows(graph)
        d, cos = embeddings_agree(a.float().cpu(), b.float().cpu())
        # bf16 activations through every layer: cuBLAS tiles an unpadded
        # product otherwise, so bf16 rounds at other places (phase 10's
        # argument for flash against "auto")
        if d > 5e-2 or cos < 0.999:
            raise AssertionError(f"{label}: padded and unpadded forwards "
                                 f"differ: max |d| {d:.3g}, least cosine "
                                 f"{cos:.6f}")
        r.update(padded_vs_unpadded_max_abs=d, padded_vs_unpadded_cos=cos)
    t = forward_turns(runner, ids, mask, rows)
    valid = int(np.asarray(mask)[:rows].sum())
    r.update(eager_host_ms=t["eager"][0], eager_device_ms=t["eager"][1],
             graph_host_ms=t["graph"][0], graph_device_ms=t["graph"][1],
             eager_tokens_per_s=valid / t["eager"][0] * 1e3,
             graph_tokens_per_s=valid / t["graph"][0] * 1e3,
             bound_ms=flops / PEAK_BF16_FLOPS * 1e3, valid_tokens=valid)
    log(f"  (b) {label} {tuple(ids.shape)} ({rows} rows, {valid} valid "
        f"tokens): graph == eager bit for bit"
        + (f"; padded vs unpadded max |d| "
           f"{r['padded_vs_unpadded_max_abs']:.3g}, least cosine "
           f"{r['padded_vs_unpadded_cos']:.6f}" if cut_rows else "")
        + f"; in turns (eager, graph, graph, eager): host "
        f"{r['eager_host_ms']:.3f} / {r['graph_host_ms']:.3f} ms a forward, "
        f"device {r['eager_device_ms']:.3f} / {r['graph_device_ms']:.3f} ms, "
        f"{r['eager_tokens_per_s']:.0f} / {r['graph_tokens_per_s']:.0f} "
        f"tokens/s; bound {r['bound_ms']:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s)")
    if layers is not None:
        path = f"{label} {ids.shape[0]}x{ids.shape[1]} replay"
        with encoder_counted(path):
            runner(ids, mask, rows)
        if ENCODER_LAUNCHES[path] != per_forward(layers, e3):
            raise AssertionError(f"{path}: E1-E3 launched "
                                 f"{ENCODER_LAUNCHES[path]}, expected "
                                 f"{per_forward(layers, e3)}")
        r["fused_launches_per_replay"] = ENCODER_LAUNCHES[path]
    if compared is not None:
        r.update(plain_chain_turns(label, runner, ids, mask, rows, compared))
    return r


def replay_order(label, runner, cases):
    """Every shape of `cases` replayed again, in reverse order and then
    interleaved, against its first graph output: bit for bit."""
    import torch
    order = list(reversed(cases)) + cases[::2] + cases[1::2]
    for c in order:
        out = runner(c["ids"], c["mask"], c["rows"])
        if not torch.equal(out, c["graph_out"]):
            raise AssertionError(f"{label}: replaying {c['shape']} out of "
                                 f"order changed its output")
    log(f"  (c) {label}: {len(order)} replays in another order than the "
        f"captures' ({[tuple(c['shape']) for c in order]}): each equal to "
        f"its first output bit for bit")


def phase_encoders(rec, e5, workdir):
    """Phase 14: the encoders' captured forward (models/graphed.py) at
    published widths with seeded random weights: (b) each shape graph
    against eager and timed, (c) replays out of capture order, (d) K6's
    launches per replay under "flash", (e) the launch loops under
    set_sync_debug_mode("error"), (f) the e5 loop of phase 8(a), graphed.
    `e5` is phase 8's e5-large-v2 generator."""
    import dataclasses
    import torch
    from neighborhoodwatch_tpu_torch.models import bert as bert_mod
    from neighborhoodwatch_tpu_torch.models import colbert as cb
    from neighborhoodwatch_tpu_torch.models import graphed
    from neighborhoodwatch_tpu_torch.models.e5 import E5EmbeddingGenerator
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    rng = np.random.default_rng(14)
    out = {}
    cfg, model = e5.config, e5.model_name
    cases = []
    for T, n in ((32, 64), (128, 64), (512, 64), (128, 37)):
        texts = bucket_texts(n, T, rng)
        ids, mask = e5.tokenizer(texts, max_length=e5.max_length)
        pids, pmask = graphed.pad_rows(ids, mask, e5.chunk_size)

        def unpadded(o, ids=ids, mask=mask):
            with torch.no_grad():
                want = e5.runner.fn(torch.from_numpy(ids).to("cuda",
                                                               torch.long),
                                    torch.from_numpy(mask).to("cuda"))
            return o, want
        c = shape_case(f"{model} ({cfg.num_layers} layers)", e5.runner,
                       pids, pmask, n, forward_flops(cfg, 64, T),
                       unpadded if n < 64 else None, layers=cfg.num_layers,
                       compared=(lambda o: o) if n == 64 else None)
        cases.append({**c, "ids": pids, "mask": pmask})
    replay_order(model, e5.runner, cases)
    out["e5"] = {f"{c['shape'][0]}x{c['shape'][1]}"
                 + ("" if c["rows"] == 64 else f"_tail{c['rows']}"):
                 {k: v for k, v in c.items() if k not in ("graph_out", "ids",
                                                          "mask")}
                 for c in cases}
    # ColBERT at bert-base width: one passage in bucket 32, a 5-row batch
    # padded to 8 in bucket 64, 64 passages in bucket 220
    col = cb.ColbertEmbeddingGenerator(device="cuda")
    runner = col._runner(64)
    ccases = []
    for T, n in ((32, 1), (64, 5), (220, 64)):
        texts = bucket_texts(n, T, rng)
        ids, mask = col.tokenizer(texts, max_length=col.max_length)
        assert ids.shape[1] == T, ids.shape
        pids, pmask = graphed.pad_rows(ids, mask,
                                       graphed.padded_rows(n, 64))

        def unpadded(o, ids=ids, mask=mask):
            with torch.no_grad():
                want = runner.fn(torch.from_numpy(ids).to("cuda", torch.long),
                                 torch.from_numpy(mask).to("cuda"))
            keep = torch.from_numpy(mask.astype(bool)).to("cuda")
            return o[keep], want[keep]

        def tokens(o, mask=pmask[:n]):
            return o[torch.from_numpy(mask.astype(bool)).to("cuda")]
        c = shape_case(f"ColBERT ({col.config.num_layers} layers)",
                       runner, pids, pmask, n,
                       forward_flops(col.config, pids.shape[0], T, head=128),
                       unpadded if n != pids.shape[0] else None,
                       layers=col.config.num_layers,
                       compared=tokens if n == 64 else None)
        got = col.encode_passages(texts)
        with graphed.forced_variant("eager"):
            want = col.encode_passages(texts)
        if got[1] != want[1] or not np.array_equal(got[0], want[0]):
            raise AssertionError(f"ColBERT encode_passages at {T}: graph "
                                 f"and eager passages differ")
        ccases.append({**c, "ids": pids, "mask": pmask})
    replay_order("ColBERT", runner, ccases)
    out["colbert"] = {f"{c['shape'][0]}x{c['shape'][1]}":
                      {k: v for k, v in c.items()
                       if k not in ("graph_out", "ids", "mask")}
                      for c in ccases}
    # (d) the e5-large flash config on the same state
    bert_mod.E5_CONFIGS[model] = dataclasses.replace(cfg,
                                                     attention_impl="flash")
    try:
        flash = E5EmbeddingGenerator(model, state=e5.model.state_dict(),
                                     device="cuda")
    finally:
        bert_mod.E5_CONFIGS[model] = cfg
    fcases, per_replay = [], {}
    for T in (128, 256, 512):
        texts = bucket_texts(64, T, rng)
        ids, mask = flash.tokenizer(texts, max_length=512)
        flash.runner(ids, mask)                 # captures
        reset_counts(ak.masked_attention)
        c = shape_case(f"{model} flash", flash.runner, ids, mask, 64,
                       forward_flops(cfg, 64, T), layers=cfg.num_layers,
                       e3=False)
        n = ak.masked_attention.launches_by_variant["wgmma"]
        reset_counts(ak.masked_attention)
        flash.runner(ids, mask)
        per_replay[str(T)] = ak.masked_attention.launches
        by = dict(ak.masked_attention.launches_by_variant)
        if by != {"mma": 0, "wgmma": cfg.num_layers}:
            raise AssertionError(f"flash bucket {T}: a replay counted {by}, "
                                 f"expected {cfg.num_layers} wgmma")
        c["k6_launches_per_replay"] = per_replay[str(T)]
        c["k6_launches_in_turns"] = n
        fcases.append({**c, "ids": ids, "mask": mask})
    replay_order(f"{model} flash", flash.runner, fcases)
    log(f"  (d) flash: K6 launches a replay by bucket {per_replay} (one a "
        f"layer, all 'wgmma', counted at replay)")
    out["e5_flash"] = {f"64x{c['shape'][1]}":
                       {k: v for k, v in c.items()
                        if k not in ("graph_out", "ids", "mask")}
                       for c in fcases}
    out["k6_launches_per_replay"] = per_replay
    del flash
    # (e) the launch loops: no synchronization before the readback
    texts = base_texts(10_000)
    passages = bucket_texts(70, 64, rng)
    e5.generate_embedding(texts)                # every shape captured
    col.encode_passages(passages)
    with no_sync_before_readback():
        e5.generate_embedding(texts)
        col.encode_passages(passages)
    log("  (e) generate_embedding over 10,000 base texts and "
        "encode_passages over 70 passages under set_sync_debug_mode("
        "'error'), the readback alone exempt: no synchronization")
    # (f) the loop phase 8(a) measured eager, graphed
    out["loop_graph"] = encoder_loop(e5, [texts], workdir, "e5 graph",
                                     [texts[:2048]])
    rec["graphs"] = out
    del col
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 15


def in_turns(fns, timer):
    """{name: ms}: each callable of `fns` timed by `timer` in turns (the
    order given, then reversed), the two timings averaged."""
    got = {n: [] for n in fns}
    for n in list(fns) + list(reversed(fns)):
        got[n].append(timer(fns[n]))
    return {n: float(np.mean(v)) for n, v in got.items()}


def row_sums(x, fn, chunk=100_000):
    """(n,) fn(rows) over row chunks of x, on the card."""
    import torch
    return torch.cat([fn(x[s:s + chunk]) for s in range(0, len(x), chunk)])


def fused_record(name, replaces, **numbers):
    return {"name": name, "route": "cuda",
            "source": f"neighborhoodwatch_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": FUSED_LAUNCHES.get("nw", {}).get(name, 0),
            "launches_by_path": {p: v[name] for p, v in
                                 FUSED_LAUNCHES.items()},
            "bound_by": "bytes", "library_ms": None, **numbers}


def fused_prepare(base):
    """(a) F1 at the headline base against its plain version: bhi bit for
    bit, bn_row within the order-of-addition bound, the statistics at or
    above their float64 truth; the two in turns; the norms-only launch."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    B, D = base.shape
    bn_p, st_p, bhi_p = fc.prepare_plain(base)
    bn_k, st_k, bhi_k = fc.prepare_base(base)
    torch.cuda.synchronize()
    same_bhi = torch.equal(bhi_k.view(torch.int16), bhi_p.view(torch.int16))
    fin = torch.isfinite(bn_p)
    rel = (D + 16) * 2.0 ** -24
    err = float((bn_k - bn_p).abs()[fin].max())
    within = bool(((bn_k - bn_p).abs() <= rel * bn_p)[fin].all())
    b64 = row_sums(base, lambda x: (x.double() ** 2).sum(1))
    lo64 = torch.cat([((base[s:s + 100_000].double()
                        - bhi_p[s:s + 100_000].double()) ** 2).sum(1)
                      for s in range(0, B, 100_000)]).sqrt()
    pos = fin & (b64 > 0)
    truth = [b64[fin].max(), b64[fin].max().sqrt(), lo64[fin].max(),
             (lo64[pos] / b64[pos].sqrt()).max()]
    bounds = all(float(st_k[j]) >= float(truth[j]) for j in range(4))
    # and within the guard of the plain version's: a kernel whose stats
    # are too loose fails the certificate on every query
    tight = all(abs(float(st_k[j]) - float(st_p[j]))
                <= 2 * rel * float(st_p[j]) for j in range(4))
    # the bits F1's norms move against torch's row sums (the norms the
    # exact engines took per tile before)
    moved = int((bn_k.view(torch.int32) != row_sums(
        base, lambda x: (x * x).sum(1)).view(torch.int32)).sum())
    del bhi_p, bn_p, b64, lo64
    torch.cuda.empty_cache()
    if not (same_bhi and within and bounds and tight):
        raise AssertionError(f"F1 vs plain: bhi bit-equal {same_bhi}, norms "
                             f"within {within}, stats {st_k.tolist()} >= "
                             f"float64 truth {bounds}, within {2 * rel:.3g}"
                             f" of the plain {st_p.tolist()} {tight}")
    t = in_turns({"plain": lambda: fc.prepare_plain(base),
                  "kernel": lambda: fc.prepare_base(base)}, event_ms)
    tn = in_turns({"plain": lambda: fc.sq_norms_plain(base),
                   "kernel": lambda: fc.sq_norms(base)}, event_ms)
    bound = (B * D * 6 + B * 4 + 16) / PEAK_BYTES * 1e3
    bound_n = (B * D * 4 + B * 4) / PEAK_BYTES * 1e3
    log(f"  (a) F1 prepare_base {B:,} x {D}: kernel {t['kernel']:.3f} ms "
        f"({t['kernel'] / bound:.2f}x the bytes bound {bound:.3f} ms), plain "
        f"{t['plain']:.2f} ms (turns plain, kernel, kernel, plain); bhi bit "
        f"for bit, max |bn_row - plain| {err:.3g} (bound {rel:.3g} x "
        f"bn_row), stats {[round(float(x), 6) for x in st_k]} >= the float64"
        f" truth {[round(float(x), 6) for x in truth]} and within "
        f"{2 * rel:.3g} x the plain {[round(float(x), 6) for x in st_p]}; "
        f"rows whose norm bits differ"
        f" from torch's row sum {moved:,} of {B:,}; norms alone: kernel "
        f"{tn['kernel']:.3f} ms (bound {bound_n:.3f}), plain "
        f"{tn['plain']:.2f} ms")
    return fused_record(
        "prepare_base", "neighborhoodwatch_tpu/ops/knn.py:251",
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        bound_ms=bound, norms_ms=tn["kernel"], norms_plain_ms=tn["plain"],
        norms_bound_ms=bound_n, norm_bits_moved=moved,
        shape=[B, D])


def fused_distance_tiles():
    """(b) F2 at the exact engines' tiles (512 x 8,192 at 1536 dims, the
    512 x 1M engines'; 1,000 x 8,192 at 1024, nw's fallback) against its
    plain version for every metric and a shifted tile's mask, bit for bit;
    the two in turns; and the distances of the old op-by-op path (torch's
    row sums as norms) against the new."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    from neighborhoodwatch_tpu_torch.ops.distance import pairwise_distance
    g = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for label, Q, T, D in (("engine_512x8192", 512, 8192, 1536),
                           ("nw_1000x8192", 1000, 8192, 1024)):
        q, b = unit_rows(Q, D, g), unit_rows(T, D, g)
        dots = q @ b.T
        qn, bn = fc.sq_norms(q), fc.sq_norms(b)
        err = 0.0
        for metric in ("sqeuclidean", "euclidean", "cosine", "dot"):
            for lo, hi in ((0, T), (3000, T - 5)):
                want = fc.distance_tile_plain(dots, qn, bn, metric, lo, hi)
                got = fc.distance_tile(dots, qn, bn, metric, lo, hi)
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"F2 {label} {metric} [{lo}, {hi})"
                                         f" differs from its plain version")
                err = max(err, float((got - want).abs().nan_to_num(0).max()))
        fns = {"plain": lambda x: fc.distance_tile_plain(
            x, qn, bn, "sqeuclidean", 0, T - 5),
            "kernel": lambda x: fc.distance_tile(
                x, qn, bn, "sqeuclidean", 0, T - 5)}
        # copies of the products, each call on its own and its output kept:
        # four times the L2 cache or more, so that no call finds its input
        # there. The card's time alone (one CUDA graph of every call), and
        # one call through the wrapper, the host's share included
        copies = max(REPS, -(-4 * L2_BYTES // (2 * Q * T * 4)))
        dots_set = [dots] + [dots.clone() for _ in range(copies - 1)]
        t = in_turns(fns, lambda f: rotating_ms(f, dots_set))
        call = in_turns(fns, lambda f: rotating_ms(f, dots_set, graph=False))
        bound = (2 * Q * T * 4 + (Q + T) * 4) / PEAK_BYTES * 1e3
        # the old path: torch's row sums as both norms, op by op
        old = fc.distance_tile_plain(dots, (q * q).sum(1), (b * b).sum(1),
                                     "sqeuclidean")
        new = pairwise_distance(q, b)
        moved = int((old.view(torch.int32) != new.view(torch.int32)).sum())
        out[label] = {"ms": t["kernel"], "plain_ms": t["plain"],
                      "copies": copies,
                      "call_ms": call["kernel"],
                      "plain_call_ms": call["plain"],
                      "bound_ms": bound, "max_abs_err": err,
                      "distance_bits_moved": moved,
                      "max_abs_moved": float((old - new).abs().max())}
        log(f"  (b) F2 distance_tile {label} (D={D}): kernel "
            f"{t['kernel']:.4f} ms ({t['kernel'] / bound:.2f}x the bytes "
            f"bound {bound:.4f} ms), plain {t['plain']:.4f} ms (a CUDA graph "
            f"of {copies} calls, each on its own copy of the products, "
            f"{copies * 2 * Q * T * 4 / 2 ** 20:.0f} MiB in and out, in "
            f"turns); one call through the wrapper (host "
            f"included) {call['kernel']:.4f} ms, plain {call['plain']:.4f} "
            f"ms; every metric and mask bit for "
            f"bit; against the old path (torch's row sums as norms) {moved:,}"
            f" of {Q * T:,} distances differ, max |d| "
            f"{out[label]['max_abs_moved']:.3g}")
        del q, b, dots, dots_set, old, new
    torch.cuda.empty_cache()
    main = out["nw_1000x8192"]
    return fused_record(
        "distance_tile", "neighborhoodwatch_tpu/ops/knn.py:138",
        max_abs_err=max(v["max_abs_err"] for v in out.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        shapes=out)


# F4 against its plain version, which cuts the same pieces and sums the
# same chunks in another order: ulps of the distance
SPLIT_ULPS = 4


def split_off_plain(d, plain):
    """max |d - plain| over the finite distances of `plain`, in ulps of
    `plain`."""
    import torch
    fin = torch.isfinite(plain)
    mag = plain.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((d - plain).abs()[fin] / ulp[fin]).max())


def fused_split_distance():
    """(e) F4 at the fallback's tiles and nw's: sqeuclidean on Gaussian
    rows with a masked edge, on 97 sampled rows the error against float64
    in units of the model's bound (fused_core.split_error_bound, twice it
    for 2 dot, plus the norms' rounding) and the ulps off the plain
    version, where the plain version without its third pieces (the bf16x3
    split) must lie beyond SPLIT_ULPS; two launches bit for bit; F4 / the
    replaced path (torch.mm fp32, TF32 off, + F2) in turns, 10 launches a
    timing, beside the bound and the plain version."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    g = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    cut = fc.split_pieces_plain

    def bf16x3(x):
        return (*cut(x)[:2], torch.zeros_like(x))
    for label, Q, T, D in (("fallback_1536", 10_000, 8192, 1536),
                           ("fallback_1024", 10_000, 8192, 1024),
                           ("nw_1024", 1000, 8192, 1024)):
        q = torch.randn(Q, D, device="cuda", generator=g)
        b = torch.randn(T, D, device="cuda", generator=g)
        qn, bn = fc.sq_norms(q), fc.sq_norms(b)
        got = fc.split_distance(q, qn, b, bn, "sqeuclidean", 0, T - 5)
        again = fc.split_distance(q, qn, b, bn, "sqeuclidean", 0, T - 5)
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"F4 {label}: two launches differ")
        pl = fc.split_distance.last_plan
        rows = torch.arange(0, Q, Q // 97, device="cuda")
        q64, b64 = q[rows].double(), b.double()
        norms = (q64 * q64).sum(1)[:, None] + (b64 * b64).sum(1)[None, :]
        want = torch.clamp_min(norms - 2.0 * q64 @ b64.T, 0.0)
        slack = 2.0 ** -24 * (2 * pl.bound * (q64.abs() @ b64.abs().T)
                              + (D + 3) * norms)
        rel = float(((got[rows, :T - 5].double() - want[:, :T - 5]).abs()
                     / slack[:, :T - 5]).max())
        if rel > 1.0 or not bool(torch.isinf(got[:, T - 5:]).all()):
            raise AssertionError(f"F4 {label}: error {rel:.3g} of the model"
                                 f" or an unmasked column")
        args = (q[rows], qn[rows], b, bn, "sqeuclidean", 0, T - 5)
        plain_rows = fc.split_distance_plain(*args)
        fc.split_pieces_plain = bf16x3
        try:
            control = fc.split_distance_plain(*args)
        finally:
            fc.split_pieces_plain = cut
        ulps = split_off_plain(got[rows], plain_rows)
        control_ulps = split_off_plain(control, plain_rows)
        if ulps > SPLIT_ULPS or control_ulps <= SPLIT_ULPS:
            raise AssertionError(
                f"F4 {label}: {ulps:.3g} ulps off its plain version, the "
                f"bf16x3 split {control_ulps:.3g} (limit {SPLIT_ULPS})")

        def split():
            return fc.split_distance(q, qn, b, bn, "sqeuclidean")

        def replaced():
            return fc.distance_tile(q @ b.T, qn, bn, "sqeuclidean")
        t = in_turns({"replaced": replaced, "kernel": split},
                     lambda f: event_ms(lambda: [f() for _ in range(REPS)])
                     / REPS)
        plain = event_ms(lambda: fc.split_distance_plain(
            q, qn, b, bn, "sqeuclidean"), runs=1)
        bound = 6 * 2 * Q * T * D / PEAK_BF16_FLOPS * 1e3
        out[label] = {"ms": t["kernel"], "replaced_ms": t["replaced"],
                      "plain_ms": plain, "bound_ms": bound,
                      "error_of_model": rel, "ulps_off_plain": ulps,
                      "bf16x3_ulps_off_plain": control_ulps, "kc": pl.kc,
                      "cluster": pl.cluster}
        log(f"  (e) F4 split_distance {label} ({Q} x {T} x {D}, kc "
            f"{pl.kc}): kernel {t['kernel']:.3f} ms ({bound / t['kernel']:.0%}"
            f" of the six-product bound {bound:.3f} ms), the replaced path "
            f"{t['replaced']:.3f} ms, plain {plain:.1f} ms; error "
            f"{rel:.3g} of the model, {ulps:.3g} ulps off the plain version "
            f"(bf16x3 {control_ulps:.3g})")
        del q, b, got, again
    torch.cuda.empty_cache()
    main = out["fallback_1536"]
    return fused_record(
        "split_distance", "neighborhoodwatch_tpu/ops/knn.py:138",
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        shapes=out, bound_by="operations", library_ms=main["replaced_ms"],
        split_launches=FUSED_LAUNCHES.get("nw", {}).get(
            "split_distance_pieces", 0),
        split_launches_by_path={p: v["split_distance_pieces"] for p, v in
                                FUSED_LAUNCHES.items()})


def merge_candidates(q, base, k):
    """The screened engine's merge input at (q, base, k): the screen's
    keys without each bin's last. Returns (merge_d, merge_i, m)."""
    from neighborhoodwatch_tpu_torch.ops import knn as K
    from neighborhoodwatch_tpu_torch.ops import screen_kernel as sk
    Q, D = q.shape
    B = base.shape[0]
    sub = sk.pick_sub(B, k, q_rows=Q)
    bn_row, stats, bhi = K._prepare_arrays(base)
    cd, ci, _ = sk.screen_candidates(q, base, epilogue="l2",
                                     screen_precision="default", n_valid=B,
                                     bn_row=bn_row, bhi=bhi, sub=sub)
    del bn_row, bhi
    _, m, _ = K._screen_plan(B, k, D, sub, 1, lean=True)
    keep, lanes = sk.KEEP, sk.LANES
    merge_d = cd.reshape(Q, -1, keep, lanes)[:, :, :keep - 1, :].reshape(
        Q, -1)
    merge_i = ci.reshape(Q, -1, keep, lanes)[:, :, :keep - 1, :].reshape(
        Q, -1)
    return merge_d, merge_i, m


def rerank_turns(label, q, base, idx_m, block):
    """F3 at (q, base, idx_m): "grouped" and "rowwise" bit for bit (fails
    otherwise), both within 1e-5 of the plain version (the blocked gather
    and torch.bmm); then plain, rowwise and grouped in turns (CUDA
    events, plain, rowwise, grouped, grouped, rowwise, plain), beside the
    bytes bound over the distinct candidate rows and over every candidate
    row. Returns the numbers, "ms" the default variant's."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import fused_core as fc
    Q, D = q.shape
    B, m = base.shape[0], idx_m.shape[1]
    default = fc.DEFAULT_VARIANT["rerank_rows"]

    def under(variant):
        def call():
            with fc.forced_variant(variant):
                return fc.rerank_rows(q, base, idx_m, "sqeuclidean", block)
        return call
    fns = {v: under(v) for v in ("plain", "rowwise", "grouped")}
    got = {v: fns[v]() for v in fns}
    plan = fc.rerank_rows.last_plan           # the grouped call's
    if plan.variant != "grouped":
        raise AssertionError(f"F3 {label}: the grouped kernel refuses "
                             f"{Q} x {m} x {D}: {plan.reason}")
    if not torch.equal(got["grouped"].view(torch.int32),
                       got["rowwise"].view(torch.int32)):
        d = float((got["grouped"] - got["rowwise"]).abs().nan_to_num(0).max())
        raise AssertionError(f"F3 {label}: 'grouped' and 'rowwise' differ, "
                             f"max |d| {d}")
    want = got["plain"]
    fin = torch.isfinite(want)
    err = float((got["rowwise"] - want).abs()[fin].max())
    if not torch.equal(torch.isfinite(got["rowwise"]), fin) or err > 1e-5:
        raise AssertionError(f"F3 {label} vs plain: max |d| {err:.3g}")
    t = in_turns(fns, event_ms)
    distinct = int(torch.unique(idx_m).numel())
    # the queries read once, the ids (int64) and distances once a pair
    small = Q * D * 4 + Q * m * (8 + 4)
    bound = (distinct * D * 4 + small) / PEAK_BYTES * 1e3
    bound_all = (Q * m * D * 4 + small) / PEAK_BYTES * 1e3
    log(f"  (c) F3 rerank_rows {label}, {Q:,} x {m} candidates x {D} over "
        f"{B:,} rows (default: {default}), "
        f"'grouped' == 'rowwise' bit for bit, in turns: grouped "
        f"{t['grouped']:.4f} ms ({t['grouped'] / bound:.2f}x the bytes bound "
        f"{bound:.4f} ms over the {distinct:,} distinct rows), rowwise "
        f"{t['rowwise']:.4f} ({t['rowwise'] / bound:.2f}x; "
        f"{t['rowwise'] / bound_all:.2f}x {bound_all:.4f} ms over every "
        f"candidate row), plain (blocks of {block} rows: gather, "
        f"torch.bmm) {t['plain']:.2f} ms; max |d - plain| {err:.3g}")
    return {"variant": default, "ms": t[default], "ms_grouped": t["grouped"],
            "ms_rowwise": t["rowwise"], "plain_ms": t["plain"],
            "bound_ms": bound, "bound_every_candidate_ms": bound_all,
            "max_abs_err": err, "distinct_rows": distinct,
            "shape": [Q, m, D, B]}


def rerank_calls(q, base, k):
    """The F3 calls of one knn(q, base, k) on the "auto" engine, as the
    engine makes them (the select's re-rank, then the class-A repair's
    where it repairs): [(query rows, ids, block), ...]."""
    from neighborhoodwatch_tpu_torch.ops import knn as K
    calls, real = [], K._exact_pair_dists

    def spy(qb, b, ids, metric, block=None):
        calls.append((qb, ids, block))
        return real(qb, b, ids, metric, block)
    K._exact_pair_dists = spy
    try:
        K.knn(q, base, k, engine="auto")
    finally:
        K._exact_pair_dists = real
    return calls


def fused_rerank(q, base, nw, k=100):
    """(c) F3 on knn(auto)'s own calls at the headline shape (the select's
    re-rank of the merge's top-m, the class-A repair's bin members) and
    on nw's own (phase 8's embeddings), each by rerank_turns; and (d) the
    merge's top-m on K7 against the stable sort, equal and in turns."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import knn as K
    merge_d, merge_i, m = merge_candidates(q, base, k)
    Q = q.shape[0]

    def by_sort():
        sd, order = torch.sort(merge_d, dim=1, stable=True)
        return sd[:, :m], torch.gather(merge_i, 1, order[:, :m])
    scr, idx_k7 = K._merge_select(merge_d, merge_i, m)
    s_scr, s_idx = by_sort()
    if not (torch.equal(scr.view(torch.int32), s_scr.view(torch.int32))
            and torch.equal(idx_k7, s_idx)):
        raise AssertionError("the merge's top-m on K7 differs from the "
                             "stable sort")
    tm = in_turns({"sort": by_sort,
                   "k7": lambda: K._merge_select(merge_d, merge_i, m)},
                  per_call_ms)
    width = merge_d.shape[1]
    log(f"  (d) the merge's top-{m} of {width:,} columns, "
        f"{Q:,} rows: K7 {tm['k7']:.3f} ms, stable sort {tm['sort']:.3f} ms "
        f"(in turns); equal, values bit for bit and ids in order")
    del merge_d, merge_i, scr, idx_k7, s_scr, s_idx
    shapes = {}
    calls = rerank_calls(q, base, k)
    for label, (qb, ids, blk) in zip(("knn_auto", "knn_auto_class_a"),
                                     calls):
        shapes[label] = rerank_turns(label, qb, base, ids, blk)
    del calls
    torch.cuda.empty_cache()
    nq, nbase = nw_embeddings(nw)
    qb, ids, blk = rerank_calls(nq, nbase, nw["k"])[0]
    shapes["nw"] = rerank_turns("nw", qb, nbase, ids, blk)
    del nq, nbase, qb, ids
    torch.cuda.empty_cache()
    main = shapes["knn_auto"]
    return fused_record(
        "rerank_rows", "neighborhoodwatch_tpu/ops/knn.py:379",
        max_abs_err=max(v["max_abs_err"] for v in shapes.values()),
        variant=main["variant"], ms=main["ms"],
        ms_grouped=main["ms_grouped"], ms_rowwise=main["ms_rowwise"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_every_candidate_ms=main["bound_every_candidate_ms"],
        distinct_rows=main["distinct_rows"], shape=main["shape"],
        shapes=shapes,
        launches_by_variant=FUSED_LAUNCHES.get("nw", {}).get(
            "rerank_rows_by_variant"),
        merge_select={"k7_ms": tm["k7"], "sort_ms": tm["sort"],
                      "rows": Q, "width": width, "m": m})


def phase_fused(nw):
    """Phase 15: F1-F4 against their plain versions at the main path's
    shapes (F3 also at phase 8's, `nw` its data), timed in turns beside
    their bounds; returns their records for the kernels line (launches:
    phase 8's nw_main, and per path)."""
    import torch
    q, base = engine_data()
    recs = [fused_prepare(base)]
    recs.append(fused_distance_tiles())
    recs.append(fused_rerank(q, base, nw))
    del q, base
    recs.append(fused_split_distance())
    torch.cuda.empty_cache()
    log(f"  fused kernels' launches by path (each counted from 0): "
        f"{FUSED_LAUNCHES}")
    return recs


# ------------------------------------------------------------ phase 16

# the published shapes: e5-large-v2 at nw's bucket and two longer ones,
# ColBERT (bert-base width) at 64 x 256 and at ck's one-passage replay (its
# synthetic passages of 17 tokens fill bucket 32, one row a forward);
# (rows, T, hidden, heads)
ENCODER_SHAPES = {"e5_64x32": (64, 32, 1024, 16),
                  "e5_64x128": (64, 128, 1024, 16),
                  "e5_64x512": (64, 512, 1024, 16),
                  "colbert_64x256": (64, 256, 768, 12),
                  "colbert_1x32": (1, 32, 768, 12)}
VOCAB = 30522
# E2 and E3's CUDA variants, timed in turns with the plain chain
STAGED_TURNS = ("plain", "rowpass", "staged")


def rotation(bytes_per_call):
    """Calls a rotating_ms timing takes: enough that their inputs and
    outputs together are four times the L2 cache, at least 4."""
    return max(4, min(64, -(-4 * L2_BYTES // bytes_per_call)))


def under_variant(variant, fn):
    """`fn` called under encoder_fused.forced_variant(variant) (so a graph
    captured of it holds that variant's launches)."""
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef

    def call(x):
        with ef.forced_variant(variant):
            return fn(x)
    return call


@contextlib.contextmanager
def staged_admitted():
    """E1's "staged" planned where the plan sends a shape to "rowpass" for
    its one full pass a block ("one pass"), so that the staged kernel can
    be timed there."""
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    real, cache = ef.row_plan, dict(ef._plans)

    def admitted(kernel, rows, width, aligned, sms, resident, batch=None):
        pl = real(kernel, rows, width, aligned, sms, resident, batch)
        if pl.reason == "one pass":
            pl = ef._embed_plan(rows, batch, width, sms, resident)
        return pl
    ef.row_plan = admitted
    ef._plans.clear()
    try:
        yield
    finally:
        ef.row_plan = real
        ef._plans.clear()
        ef._plans.update(cache)


def variant_turns(name, inputs, wrapper, plain, yardstick=None):
    """E1, E2 or E3 on `inputs`: "rowpass" against "staged" bit for bit on
    every input (fails otherwise); then plain, "rowpass" and
    "staged" in turns, cold (rotating_ms: each call on its own input, the
    calls' bytes four times the L2 or more) and hot (graph_ms: one input
    again and again, as the forward finds E2's operands just written),
    beside the yardstick where there is one (E2, E3: one ATen row pass
    over about the same bytes, not the same function), cold and hot.
    "staged" is on its plan: where the plan sends a shape to "rowpass",
    both time the same launch (the plan and its reason are returned)."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    staged = under_variant("staged", wrapper)
    rowpass = under_variant("rowpass", wrapper)
    for x in inputs:
        a, b = staged(x), rowpass(x)
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            d = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"{name}: 'staged' and 'rowpass' differ "
                                 f"at {tuple(a.shape)}: max |d| {d}")
    plan = getattr(ef, name).last_plan
    fns = {"plain": plain, "rowpass": rowpass, "staged": staged}
    cold = in_turns({v: (lambda f=fns[v]: rotating_ms(f, inputs))
                     for v in STAGED_TURNS}, lambda f: f())
    hot = in_turns({v: (lambda f=fns[v]: graph_ms(lambda: f(inputs[0])))
                    for v in STAGED_TURNS}, lambda f: f())
    yard = (rotating_ms(yardstick, inputs),
            graph_ms(lambda: yardstick(inputs[0]))) if yardstick else \
        (None, None)
    default = ef.DEFAULT_VARIANT[name]
    return {"variant": default, "ms": cold[default],
            "ms_rowpass": cold["rowpass"], "ms_staged": cold["staged"],
            "plain_ms": cold["plain"], "hot_ms": hot[default],
            "hot_ms_rowpass": hot["rowpass"], "hot_ms_staged": hot["staged"],
            "hot_plain_ms": hot["plain"],
            "yardstick_ms": yard[0], "hot_yardstick_ms": yard[1],
            "plan": dict(vars(plan)) if plan is not None else None}


def encoder_fused_shape(label, rows, T, H, heads, g):
    """Phase 16 at one shape: E1-E3 against their plain versions on the
    same bf16 inputs (outputs_agree: one bf16 ulp, plus 1e-5 abs for the
    LayerNorms' cancellations near 0); each by variant_turns ("staged" ==
    "rowpass" bit for bit, the three timed in turns cold and hot; E2 and
    E3 beside the ATen yardstick) beside its bytes bound. Returns {kernel:
    numbers}."""
    import torch
    import torch.nn.functional as F
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    bf16, d, eps = torch.bfloat16, H // heads, 1e-12
    lengths = torch.randint(1, T + 1, (rows,), device="cuda", generator=g)
    if rows > 1:
        lengths[-1] = 0                          # a pad row
    mask = torch.arange(T, device="cuda")[None, :] < lengths[:, None]
    w = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    b = 0.1 * torch.randn(H, device="cuda", generator=g)
    word = 0.05 * torch.randn(VOCAB, H, device="cuda", generator=g)
    pos = 0.05 * torch.randn(512, H, device="cuda", generator=g)
    typ = 0.05 * torch.randn(2, H, device="cuda", generator=g)
    out = {}

    def case(name, make, kernel, plain, bound_bytes, call_bytes,
             yardstick=None):
        """`bound_bytes(x)`: the bytes a call on input x must move."""
        n = rotation(call_bytes)
        inputs = [make() for _ in range(n)]
        err = ef.outputs_agree(kernel(inputs[0]), plain(inputs[0]),
                               0.0 if name == "masked_softmax" else
                               ef.LN_ATOL)
        bound = bound_bytes(inputs[0]) / PEAK_BYTES * 1e3
        r = variant_turns(name, inputs, kernel, plain, yardstick)
        if (r["plan"] or {}).get("reason") == "one pass":
            # the staged kernel itself, past the plan's rule, in turns with
            # "rowpass", bit for bit
            staged = under_variant("staged", kernel)
            with staged_admitted():
                if not torch.equal(staged(inputs[0]).view(torch.uint8),
                                   under_variant("rowpass", kernel)(
                                       inputs[0]).view(torch.uint8)):
                    raise AssertionError(f"{name} {label}: the staged "
                                         f"kernel differs from 'rowpass'")
                t = in_turns({"rowpass": lambda: rotating_ms(
                    under_variant("rowpass", kernel), inputs),
                    "staged": lambda: rotating_ms(staged, inputs)},
                    lambda f: f())
                r["one_pass"] = {"ms_staged": t["staged"],
                                 "ms_rowpass": t["rowpass"],
                                 "plan": dict(vars(ef.embed_layernorm
                                                   .last_plan))}
            log(f"  {name} {label}: the plan sends it to 'rowpass' (one "
                f"pass); the staged kernel past that rule, cold, in turns: "
                f"staged {t['staged']:.4f} ms, rowpass {t['rowpass']:.4f} "
                f"(plan {r['one_pass']['plan']})")
        out[name] = {**r, "bound_ms": bound, "max_abs_err": err, "calls": n}
        yard = "" if yardstick is None else (
            f", yardstick {r['yardstick_ms']:.4f}")
        hot_yard = "" if yardstick is None else (
            f", yardstick {r['hot_yardstick_ms']:.4f}")
        log(f"  {name} {label}: 'rowpass' == 'staged' bit for bit on "
            f"{n} inputs; cold (a CUDA graph of {n} calls, each on its "
            f"own inputs, in turns): rowpass {r['ms_rowpass']:.4f} ms "
            f"({r['ms_rowpass'] / bound:.2f}x the bytes bound "
            f"{bound:.4f} ms), staged {r['ms_staged']:.4f} "
            f"({r['ms_staged'] / bound:.2f}x), plain "
            f"{r['plain_ms']:.4f}{yard}; hot (one input, {REPS} calls): "
            f"rowpass {r['hot_ms_rowpass']:.4f}, staged "
            f"{r['hot_ms_staged']:.4f}, plain "
            f"{r['hot_plain_ms']:.4f}{hot_yard}; plan {r['plan']}; max "
            f"|d - plain| {err:.3g}")
        del inputs

    def ids():
        return torch.randint(0, VOCAB, (rows, T), device="cuda", generator=g)
    out_bytes = rows * T * H * 2
    # the ids, each distinct word row once, the position rows, the type
    # row, the weights, the output
    case("embed_layernorm", ids,
         lambda i: ef.embed_layernorm(i, word, pos, typ, w, b, eps, bf16),
         lambda i: ef.embed_layernorm_plain(i, word, pos, typ, w, b, eps,
                                            bf16),
         lambda i: (rows * T * 8 + int(torch.unique(i).numel()) * H * 4
                    + (T + 3) * H * 4 + out_bytes),
         rows * T * H * 4 + out_bytes)

    def pair():
        return (torch.randn(rows, T, H, device="cuda", generator=g).to(bf16),
                torch.randn(rows, T, H, device="cuda", generator=g).to(bf16))
    wb16, bb16 = w.to(bf16), b.to(bf16)
    # yardstick: ATen's LayerNorm of one bf16 (rows, n) tensor (a read and
    # a write of it: two thirds of E2's bytes)
    case("add_layernorm", pair,
         lambda p: ef.add_layernorm(*p, w, b, eps),
         lambda p: ef.add_layernorm_plain(*p, w, b, eps),
         lambda p: 3 * out_bytes + 2 * H * 4, 3 * out_bytes,
         yardstick=lambda p: F.layer_norm(p[0], (H,), wb16, bb16, eps))

    def logits():
        q = torch.randn(rows, heads, T, d, device="cuda", generator=g)
        k = torch.randn(rows, heads, T, d, device="cuda", generator=g)
        return (q.to(bf16) @ k.to(bf16).transpose(2, 3))
    probs = rows * heads * T * T * 2
    # yardstick: ATen's softmax over the bf16 logits (E3's bytes, without
    # the scale, the mask and the fp32 widening)
    case("masked_softmax", logits,
         lambda x: ef.masked_softmax(x, mask, d),
         lambda x: ef.masked_softmax_plain(x, mask, d),
         lambda x: 2 * probs + rows * T, 2 * probs,
         yardstick=lambda x: torch.softmax(x, dim=-1))
    del word, pos, typ
    torch.cuda.empty_cache()
    return out


def phase_encoder_fused():
    """Phase 16: E1-E3 against their plain versions at the published
    shapes, E2 and E3's variants against each other, timed in turns beside
    their bounds; returns their records for the kernels line (ms, plain
    and bound at nw's 64 x 32, ms on each kernel's default variant, E2
    and E3 each variant's as ms_rowpass and ms_staged; launches: phase
    8's nw_main, and per path)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(16)
    shapes = {label: encoder_fused_shape(label, *dims, g)
              for label, dims in ENCODER_SHAPES.items()}
    replaces = {"embed_layernorm": "neighborhoodwatch_tpu/models/"
                                   "bert_flax.py:165",
                "add_layernorm": "neighborhoodwatch_tpu/models/"
                                 "bert_flax.py:145",
                "masked_softmax": "neighborhoodwatch_tpu/models/"
                                  "bert_flax.py:118"}
    recs = []
    for name in ENCODER_KERNELS:
        main = shapes["e5_64x32"][name]
        rec = {
            "name": name, "route": "cuda",
            "source": f"neighborhoodwatch_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": ENCODER_LAUNCHES.get("nw", {}).get(name, 0),
            "launches_by_path": {p: v[name] for p, v in
                                 ENCODER_LAUNCHES.items()},
            "launches_by_variant": ENCODER_VARIANTS.get("nw", {}).get(name),
            "max_abs_err": max(v[name]["max_abs_err"]
                               for v in shapes.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shapes": {label: v[name] for label, v in shapes.items()}}
        rec.update(variant=main["variant"], ms_rowpass=main["ms_rowpass"],
                   ms_staged=main["ms_staged"])
        if name != "embed_layernorm":
            rec.update(yardstick_ms=main["yardstick_ms"],
                       yardstick="ATen " + ("layer_norm" if name ==
                                            "add_layernorm" else "softmax")
                       + ", not the same function")
        recs.append(rec)
    log(f"  encoder fused kernels' launches by path (each counted from 0): "
        f"{ENCODER_LAUNCHES}; by variant {ENCODER_VARIANTS}")
    return recs


# ------------------------------------------------------------ phase 17

# M1's shapes (Q, Tq, D, Td, dim): the stream's and ck's exact fallback
# step (2,048-doc tiles), phase 6(b)'s Td, the exact engine's default
# 128-doc tile, a ragged shape; M2's (B, M, N, Tq, Td, dim): the re-rank's
# (1,000, m=256) candidates over an 8,192-doc tile, phase 6(b)'s 50,000 x
# 64 docs, the class-A repair's 512 bin members a query, a ragged shape
DENSE_SHAPES = {"stream_fallback": (718, 32, 2048, 16, 128),
                "td64": (718, 32, 2048, 64, 128),
                "exact_tile": (1000, 32, 128, 16, 128),
                "ragged": (29, 13, 501, 7, 96)}
PAIRS_SHAPES = {"rerank_8192": (1000, 256, 8192, 32, 16, 128),
                "rerank_td64": (1000, 256, 50_000, 32, 64, 128),
                "class_a": (64, 512, 8192, 32, 16, 128),
                "ragged": (29, 37, 501, 13, 7, 96)}


def planted_tokens(n, t, dim, gen, planted=True):
    """(n, t, dim) unit tokens with (n, t) ragged masks on the card; with
    `planted`: passage 1 all masked, passage 2 all masked too on the doc
    side, NaN in a valid token (3) and in a masked one (6), +inf and -inf
    in a valid token (5), inf in a masked token (4), NaN in the last
    passage's last token, masked."""
    import torch
    x = unit_tokens(n, t, dim, gen)
    m = torch.rand((n, t), device="cuda", generator=gen) < 0.8
    m[:, 0] = True
    if planted:
        m[1:3] = False
        m[2, 0] = True                 # a doc side keeps one token
        x[3, 0, 0] = float("nan")
        x[4, t - 1] = float("inf")
        m[4, t - 1] = t == 1
        x[5, 0, ::2] = float("inf")
        x[5, 0, 1::2] = -float("inf")
        x[6, t // 2] = float("nan")
        m[6, t // 2] = t // 2 == 0
        x[n - 1, t - 1, 0] = float("nan")
        m[n - 1, t - 1] = t == 1
    return x, m


def scores_agree(got, want, nan_is_neg):
    """Scores within 1e-3 relative (at least 1e-3 absolute), the MaxSim
    tolerance; M1 (`nan_is_neg`): no NaN and the -1e30 positions equal bit
    for bit; M2: the NaN positions equal; infinite positions equal.
    Returns the largest |got - want| over the finite scores below 1e29."""
    import torch
    neg = float(np.float32(-1e30))
    if nan_is_neg:
        at = want == neg
        if torch.isnan(got).any() or not torch.equal(got == neg, at) \
                or not torch.equal(got[at], want[at]):
            raise AssertionError("M1: the -1e30 (NaN) positions differ")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("the NaN positions differ")
    inf = torch.isinf(want)
    if not torch.equal(got[inf], want[inf]):
        raise AssertionError("the infinite positions differ")
    fin = torch.isfinite(want) & (want != neg)
    err = (got[fin].double() - want[fin].double()).abs()
    tol = 1e-3 * want[fin].double().abs().clamp_min(1.0)
    if bool((err > tol).any()):
        raise AssertionError(f"scores beyond 1e-3: {float((err - tol).max())}")
    # reported over the scores of real tokens: a doc with every token
    # masked scores a multiple of -1e30, held above by the relative bound
    real = (want[fin].abs() < 1e29).double()
    return float((err * real).max()) if err.numel() else 0.0


MAXSIM_TURNS = ("plain", "ffma", "split")


def maxsim_oracle(q, qm, d, dm, ids=None, chunk=8):
    """float64 MaxSim on the card, query passages `chunk` at a time: the
    scores (NaN kept; with `ids`, each passage against its own candidates,
    an id outside the docs NaN) and two error scales a score: `sel`, the
    sum over valid query tokens t of sum_k |q_tk d_sk| at the doc token s
    the max selects, and `worst`, the same at the s with the largest such
    sum (it bounds the error wherever the max falls)."""
    import torch
    qd = q.double()
    dd = d.double() if ids is None else None
    scores, sels, worsts = [], [], []
    for s in range(0, q.shape[0], chunk):
        qs, on = qd[s:s + chunk], qm[s:s + chunk, :, None]
        if ids is None:
            sims = torch.einsum("qtk,dsk->qtds", qs, dd)
            absd = torch.einsum("qtk,dsk->qtds", qs.abs(), dd.abs())
            valid = dm[None, None]
        else:
            ib = ids[s:s + chunk].long()
            inside = (ib >= 0) & (ib < d.shape[0])
            cand = d[ib.clamp(0, d.shape[0] - 1)].double()
            sims = torch.einsum("qtk,qmsk->qtms", qs, cand)
            absd = torch.einsum("qtk,qmsk->qtms", qs.abs(), cand.abs())
            valid = dm[ib.clamp(0, d.shape[0] - 1)][:, None]
        absd = torch.nan_to_num(absd, nan=float("inf"))
        sel = torch.where(valid, sims, -1e30)
        tok = torch.where(torch.isnan(sel).any(3), float("nan"),
                          sel.amax(3))
        pick = torch.where(valid, sims, -float("inf")).nan_to_num(
            nan=-float("inf")).argmax(3, keepdim=True)
        a_sel = absd.gather(3, pick)[..., 0]
        a_worst = torch.where(valid, absd, 0.0).amax(3)
        score = torch.where(on, tok, 0.0).sum(1)
        if ids is not None:
            score = torch.where(inside, score, float("nan"))
        scores.append(score)
        sels.append(torch.where(on, a_sel, 0.0).sum(1))
        worsts.append(torch.where(on, a_worst, 0.0).sum(1))
    return torch.cat(scores), torch.cat(sels), torch.cat(worsts)


def oracle_error(got, oracle, sel, worst, dot_bound, what):
    """The largest |score - float64 score| over the finite scores (below
    1e29), in units of 2^-24 sel (the selected pair's sum_t sum_k |q d|);
    raises unless every one is within (dot_bound + 64) 2^-24 worst: the
    dot's error model plus the token sum's 64 (maxsim_acc_rel's)."""
    import torch
    fin = torch.isfinite(oracle) & (oracle.abs() < 1e29) & \
        torch.isfinite(worst)
    err = (got.double() - oracle)[fin].abs()
    if err.numel() == 0:
        return 0.0
    lim = (dot_bound + 64) * 2.0 ** -24 * worst[fin]
    if bool((err > lim).any()):
        raise AssertionError(f"{what}: error beyond the model, "
                             f"{float((err / lim).max()):.3g} x its limit")
    return float((err / (sel[fin].clamp_min(1e-300) * 2.0 ** -24)).max())


def dot_bound_of(wrapper, variant, dim):
    """The dot's error bound (units of 2^-24 sum_k |q d|) of the variant
    that ran: the "split" plan's, or dim for "ffma" (fp32 FMA)."""
    pl = wrapper.last_plan
    if variant == "split" and pl is not None and pl.variant == "split":
        return pl.error_bound
    return float(dim)


def maxsim_bounds(flops, pieces, dim_ops):
    """The FFMA bound (fp32 FLOP at 67 TFLOP/s) and the split's tensor
    bound (the bf16 products it runs at 989 TFLOP/s: six of the fp32
    work at 3 pieces; one at 1 piece, of its `dim_ops`-wide operands), ms."""
    return (flops / PEAK_FP32_FLOPS * 1e3,
            flops * (6 if pieces == 3 else dim_ops) / PEAK_BF16_FLOPS * 1e3)


def variant_checks(name, label, call, plain, oracle, dim, nan_is_neg):
    """Each variant of one wrapper at one shape and precision: two
    launches bit for bit, the plain version's scores (MaxSim tolerance,
    planted positions), the float64 oracle within the variant's model.
    Returns {variant: {err_plain, err_oracle, plan}}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    wrapper = getattr(mf, name)
    out = {}
    for variant in mf.VARIANTS:
        with mf.forced_variant(variant):
            got = call()
            again = call()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{name} {label} [{variant}]: two launches "
                                 f"differ")
        taken = wrapper.last_plan.variant if variant == "split" else "ffma"
        out[variant] = {
            "ran": taken,
            "err_plain": scores_agree(got, plain, nan_is_neg),
            "err_oracle": oracle_error(
                got, oracle[0], oracle[1], oracle[2],
                dot_bound_of(wrapper, variant, dim),
                f"{name} {label} [{variant}]"),
            "dot_bound": dot_bound_of(wrapper, variant, dim)}
    return out


def variant_timings(fns, inputs, graph):
    """{variant: ms}: plain, ffma and split in turns (that order, then
    reversed), each by rotating_ms over `inputs`."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf

    def timer(v):
        if v == "plain":
            return lambda: rotating_ms(fns["plain"], inputs, graph)

        def run(x):
            with mf.forced_variant(v):
                return fns["kernel"](x)
        return lambda: rotating_ms(run, inputs, graph)
    return in_turns({v: timer(v) for v in MAXSIM_TURNS}, lambda f: f())


def dense_case(label, Q, Tq, D, Td, dim, gen, timed):
    """M1 at one shape, every precision where the shape is small, garbage
    planted on both sides: each variant against the plain version and the
    float64 oracle, two launches bit for bit; `timed`: plain, ffma and
    split in turns by rotating_ms, beside both bounds."""
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    q, qm = planted_tokens(Q, Tq, dim, gen)
    d, dm = planted_tokens(D, Td, dim, gen)
    precisions = ("highest",) if Q * D > 200_000 else \
        ("highest", "high", "default")
    rec = {"shape": [Q, Tq, D, Td, dim], "precisions": {}}
    flops = 2.0 * Q * Tq * D * Td * dim
    bytes_ = (Q * Tq + D * Td) * (dim * 4 + 1) + Q * D * 4
    for precision in precisions:
        qo, do = mf.maxsim_operands(q, d, precision)
        pieces = 3 if precision == "highest" else 1
        plain = mf.maxsim_dense_plain(q, qm, d, dm, precision)
        checks = variant_checks(
            "maxsim_dense", label,
            lambda: mf.maxsim_dense(q, qm, d, dm, precision), plain,
            maxsim_oracle(qo, qm, do, dm), do.shape[2], True)
        ffma_b, split_b = maxsim_bounds(flops, pieces, do.shape[2] // dim)
        prec = {"checks": checks, "ffma_bound_ms": ffma_b,
                "split_bound_ms": split_b,
                "plan": dict(vars(mf.maxsim_dense.last_plan))}
        if timed:
            # each call on its own queries and docs, four times the L2 or
            # more; the main shapes in a CUDA graph, phase 6(b)'s (whose
            # plain version writes 12 GB a call) issued from the host
            n = rotation(bytes_)
            inputs = [(q, qm, d, dm)] + [
                (q.clone(), qm, d.clone(), dm) for _ in range(n - 1)]
            t = variant_timings(
                {"plain": lambda x: mf.maxsim_dense_plain(*x, precision),
                 "kernel": lambda x: mf.maxsim_dense(*x, precision)},
                inputs, timed == "graph")
            prec.update(ms=t, calls=n, timing="a CUDA graph" if timed ==
                        "graph" else "host-issued",
                        x_ffma_bound={v: t[v] / ffma_b for v in t},
                        x_split_bound={v: t[v] / split_b for v in t},
                        tflops={v: flops / t[v] / 1e9 for v in t})
            del inputs
        rec["precisions"][precision] = prec
        log(f"  M1 maxsim_dense {label} {Q} x {Tq} vs {D} x {Td} x {dim} "
            f"[{precision}]: " + "; ".join(
                f"{v} ({c['ran']}) |score - plain| {c['err_plain']:.3g}, "
                f"|score - float64| {c['err_oracle']:.3g} 2^-24 sum|q d| "
                f"(model {c['dot_bound']:.1f} + 64)"
                for v, c in checks.items())
            + "; NaN -> -1e30 and masked positions equal, two launches "
              "bit for bit"
            + ("; " + ", ".join(
                f"{v} {prec['ms'][v]:.3f} ms ({prec['tflops'][v]:.1f} "
                f"TFLOP/s, {prec['x_ffma_bound'][v]:.2f}x the FFMA bound "
                f"{ffma_b:.3f}, {prec['x_split_bound'][v]:.2f}x the split "
                f"bound {split_b:.3f})" for v in MAXSIM_TURNS)
               + f" ({prec['timing']} run of {prec['calls']} calls, each on "
                 f"its own inputs, in turns)" if timed else ""))
    main = rec["precisions"]["highest"]
    rec["max_abs_err"] = max(c["err_plain"] for p in rec["precisions"].values()
                             for c in p["checks"].values())
    rec["bound_ms"] = main["split_bound_ms"]
    rec["ffma_bound_ms"] = main["ffma_bound_ms"]
    rec["bound_by"] = "operations" if flops / PEAK_FP32_FLOPS >= \
        bytes_ / PEAK_BYTES else "bytes"
    if timed:
        rec["ms_by_variant"] = main["ms"]
        rec["plain_ms"] = main["ms"]["plain"]
    return rec


def pairs_case(label, B, M, N, Tq, Td, dim, gen, timed):
    """M2 at one shape, garbage planted and ids outside the docs: each
    variant against the plain version (the gather in the engine's blocks)
    and the float64 oracle (on 32 queries), two launches bit for bit;
    `timed`: plain, ffma and split in turns, beside both bounds."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim as MS
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    q, qm = planted_tokens(B, Tq, dim, gen)
    d, dm = planted_tokens(N, Td, dim, gen)
    ids = torch.randint(0, N, (B, M), device="cuda", generator=gen)
    ids[0, :2] = torch.tensor([-1, N])          # outside the docs: NaN
    ids[2, :3] = torch.tensor([2, 3, 5])        # the garbage docs
    block = MS.maxsim_screen_plan(N, 100, Td, dim)[1]
    plain = mf.maxsim_pairs_plain(q, qm, d, dm, ids, block)
    n_or = min(B, 32)
    oracle = maxsim_oracle(q[:n_or], qm[:n_or], d, dm, ids[:n_or])
    pad = [torch.full((B - n_or, M), float("nan"), device="cuda",
                      dtype=torch.float64) for _ in range(3)]
    oracle = tuple(torch.cat([o, p]) for o, p in zip(oracle, pad))
    checks = variant_checks(
        "maxsim_pairs", label, lambda: mf.maxsim_pairs(q, qm, d, dm, ids),
        plain, oracle, dim, False)
    for v in mf.VARIANTS:
        with mf.forced_variant(v):
            got = mf.maxsim_pairs(q, qm, d, dm, ids)
        if not bool(torch.isnan(got[0, :2]).all() & torch.isnan(got[2, 1])):
            raise AssertionError(f"M2 {label} [{v}]: a planted NaN did not "
                                 f"pass")
    distinct = int(torch.unique(ids.clamp(0, N - 1)).numel())
    flops = 2.0 * B * M * Tq * Td * dim
    bytes_ = (B * Tq * (dim * 4 + 1) + distinct * Td * (dim * 4 + 1)
              + B * M * 12)
    ffma_b, split_b = maxsim_bounds(flops, 3, 1)
    rec = {"shape": [B, M, N, Tq, Td, dim], "checks": checks,
           "max_abs_err": max(c["err_plain"] for c in checks.values()),
           "distinct_docs": distinct, "plain_block": block,
           "plan": dict(vars(mf.maxsim_pairs.last_plan)),
           "bound_ms": split_b, "ffma_bound_ms": ffma_b,
           "bound_by": "operations" if flops / PEAK_FP32_FLOPS
           >= bytes_ / PEAK_BYTES else "bytes"}
    if timed:
        per_call = B * Tq * dim * 4 + N * Td * dim * 4 + B * M * 12
        n = rotation(per_call)
        inputs = [(q, qm, d, dm, ids)] + [
            (q.clone(), qm, d.clone(), dm, ids.clone())
            for _ in range(n - 1)]
        t = variant_timings(
            {"plain": lambda x: mf.maxsim_pairs_plain(*x, block),
             "kernel": lambda x: mf.maxsim_pairs(*x)},
            inputs, timed == "graph")
        rec.update(ms_by_variant=t, plain_ms=t["plain"], calls=n,
                   timing="a CUDA graph" if timed == "graph" else
                   "host-issued",
                   x_ffma_bound={v: t[v] / ffma_b for v in t},
                   x_split_bound={v: t[v] / split_b for v in t},
                   tflops={v: flops / t[v] / 1e9 for v in t})
        del inputs
    log(f"  M2 maxsim_pairs {label} {B} x {M} candidates of {N} x {Td} "
        f"(Tq {Tq}, dim {dim}; {distinct:,} distinct): " + "; ".join(
            f"{v} ({c['ran']}) |score - plain| {c['err_plain']:.3g}, "
            f"|score - float64| {c['err_oracle']:.3g} 2^-24 sum|q d| "
            f"(model {c['dot_bound']:.1f} + 64)" for v, c in checks.items())
        + "; NaN positions equal, two launches bit for bit"
        + ("; " + ", ".join(
            f"{v} {t[v]:.3f} ms ({rec['tflops'][v]:.1f} TFLOP/s, "
            f"{rec['x_ffma_bound'][v]:.2f}x the FFMA bound {ffma_b:.3f}, "
            f"{rec['x_split_bound'][v]:.2f}x the split bound {split_b:.3f})"
            for v in MAXSIM_TURNS)
           + f" (plain: the gather in blocks of {block}; {rec['timing']} "
             f"run of {n} calls, each on its own inputs, in turns)"
           if timed else ""))
    return rec


def maxsim_adversarial():
    """Dots that are hard for a split: heavy cancellation, a wide
    exponent range, a value near FLT_MAX (64 one-token passages against
    64 one-token docs, so a score is one dot), each variant within its
    error model of the float64 dot. Returns {variant: worst error in
    units of 2^-24 sum_k |q_k d_k|}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    rng = np.random.default_rng(17)
    dim = 128
    a = rng.standard_normal((64, dim)).astype(np.float32)
    b = rng.standard_normal((64, dim)).astype(np.float32)
    prod = rng.standard_normal(dim) * 1e3
    prod[-1] = -prod[:-1].sum()
    b[0] = (prod / np.where(a[0] == 0, 1, a[0])).astype(np.float32)
    a[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    b[1] *= (2.0 ** rng.integers(-20, 20, dim)).astype(np.float32)
    a[2, 0] = np.float32(3.3e38)
    b[:, 0] = np.float32(1e-30)
    q = torch.from_numpy(a[:, None]).cuda()
    d = torch.from_numpy(b[:, None]).cuda()
    m = torch.ones((64, 1), dtype=torch.bool, device="cuda")
    exact = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64).T)
    scale = torch.from_numpy(np.abs(a.astype(np.float64))
                             @ np.abs(b.astype(np.float64)).T)
    out = {}
    for v in mf.VARIANTS:
        with mf.forced_variant(v):
            got = mf.maxsim_dense(q, m, d, m).double().cpu()
        bound = dot_bound_of(mf.maxsim_dense, v, dim)
        err = (got - exact).abs() / (scale * 2.0 ** -24)
        if bool((err > bound).any()):
            raise AssertionError(f"M1 [{v}] adversarial dots: "
                                 f"{float(err.max()):.3g} > {bound:.1f}")
        out[v] = float(err.max())
    log(f"  M1 adversarial dots (cancellation, exponents 2^-20 .. 2^20, "
        f"3.3e38 x 1e-30): worst error in 2^-24 sum|q d|: " + ", ".join(
            f"{v} {e:.2f} (model {dot_bound_of(mf.maxsim_dense, v, dim):.1f}"
            f")" for v, e in out.items()))
    return out


def product_yardstick_ms(Q, Tq, D, Td, dim, gen):
    """One torch.mm of M1's fp32 operands at a shape, TF32 off: the
    products alone, no mask, max or sum (a yardstick the port never
    calls), by CUDA events around REPS calls."""
    import torch
    a = unit_tokens(Q, Tq, dim, gen).reshape(Q * Tq, dim)
    b = unit_tokens(D, Td, dim, gen).reshape(D * Td, dim)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = per_call_ms(lambda: torch.mm(a, b.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    del a, b
    return ms


def phase_maxsim_fused():
    """Phase 17: M1 and M2, both variants, against their plain versions
    and a float64 oracle at the main path's shapes, garbage planted,
    timed in turns with the plain version beside both bounds; the
    adversarial dots; returns their records for the kernels line
    (launches: phase 7's ck_main, and per path)."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import maxsim_fused as mf
    g = torch.Generator(device="cuda").manual_seed(17)
    timed = {"stream_fallback": "graph", "td64": "host",
             "exact_tile": "graph", "ragged": "graph",
             "rerank_8192": "graph", "rerank_td64": "host",
             "class_a": "graph"}
    dense = {label: dense_case(label, *shape, g, timed.get(label))
             for label, shape in DENSE_SHAPES.items()}
    torch.cuda.empty_cache()
    pairs = {label: pairs_case(label, *shape, g, timed.get(label,
                                                           "graph"))
             for label, shape in PAIRS_SHAPES.items()}
    torch.cuda.empty_cache()
    adversarial = maxsim_adversarial()
    yard = product_yardstick_ms(*DENSE_SHAPES["stream_fallback"], g)
    log(f"  product-only yardstick at M1's stream fallback step: torch.mm "
        f"of the fp32 operands, TF32 off, {yard:.3f} ms (no mask, max or "
        f"sum)")
    recs = []
    for name, shapes, main, replaces in (
            ("maxsim_dense", dense, "stream_fallback",
             "neighborhoodwatch_tpu/ops/maxsim.py:33"),
            ("maxsim_pairs", pairs, "rerank_8192",
             "neighborhoodwatch_tpu/ops/maxsim.py:260")):
        top = shapes[main]
        default = mf.DEFAULT_VARIANT[name]
        recs.append({
            "name": name, "route": "cuda",
            "source": f"neighborhoodwatch_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "variant": default,
            "launches": MAXSIM_LAUNCHES.get("ck", {}).get(name, 0),
            "launches_by_variant": MAXSIM_LAUNCHES.get("ck", {}).get(
                f"{name}_by_variant", {}),
            "launches_by_path": {p: v[name] for p, v in
                                 MAXSIM_LAUNCHES.items()},
            "launches_by_path_variant": {
                p: v[f"{name}_by_variant"] for p, v in
                MAXSIM_LAUNCHES.items()},
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "ms": top["ms_by_variant"][default],
            "ms_by_variant": top["ms_by_variant"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "ffma_bound_ms": top["ffma_bound_ms"],
            "library_ms": None, "shapes": shapes})
    recs[0]["product_yardstick_ms"] = yard
    recs[0]["adversarial"] = adversarial
    log(f"  MaxSim fused kernels' launches by path (each counted from 0): "
        f"{MAXSIM_LAUNCHES}")
    return recs


# ------------------------------------------------------------ phase 18

# the decoder embedder's passes (ops/encoder_fused.py, csrc/decoder_passes.cu)
DECODER_KERNELS = ("add_rmsnorm", "rope", "swiglu")
# e5-mistral-7b-instruct's widths (models/decoder.py's DecoderConfig) at
# the benchmark's forward: 64 texts at bucket 512
DECODER_ROWS, DECODER_T = 64, 512
# launches of one 32-layer forward: D1 at the embedding and twice a
# layer, D2, D3 and K6's causal mode once a layer
DECODER_PER_FORWARD = {"add_rmsnorm": 65, "rope": 32, "swiglu": 32,
                       "causal": 32}


def must_fail(check, what):
    """Fail unless `check()` raises AssertionError: a control that the
    comparison has to catch."""
    try:
        check()
    except AssertionError:
        return
    raise AssertionError(f"control not caught: {what}")


def bits_equal(a, b):
    import torch
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def kernel_plain_turns(kernel, plain, inputs):
    """{"ms", "plain_ms"}: the kernel and its plain version cold
    (rotating_ms over `inputs`), in turns (kernel, plain, plain, kernel)."""
    t = in_turns({"kernel": lambda: rotating_ms(kernel, inputs),
                  "plain": lambda: rotating_ms(plain, inputs)},
                 lambda f: f())
    return {"ms": t["kernel"], "plain_ms": t["plain"]}


def decoder_passes_vs_plain(g, cfg):
    """D1-D3 at 64 x 512 of the published widths, bf16: against their
    plain versions on the same inputs at the card tests' tolerances (D1's
    residual and D2 bit for bit, D1's norm and D3 within one bf16 ulp,
    encoder_fused.outputs_agree), each with a control the comparison must
    catch; then timed in turns with the plain version, cold, beside the
    bytes bound (each operand read once, each result written once).
    Returns {kernel: numbers}."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    bf16, eps = torch.bfloat16, cfg.rms_norm_eps
    rows, h, d = DECODER_ROWS * DECODER_T, cfg.hidden_size, cfg.head_dim
    heads = cfg.num_heads + cfg.num_kv_heads            # q and k rotated
    qkv_w = (cfg.num_heads + 2 * cfg.num_kv_heads) * d
    inter = cfg.intermediate_size
    shape = (DECODER_ROWS, DECODER_T)
    out = {}

    def randn(*s, scale=1.0):
        return (scale * torch.randn(*shape, *s, device="cuda",
                                    generator=g)).to(bf16)

    # D1: the residual add and the RMSNorm after it; control: no add
    w = 1 + 0.1 * torch.randn(h, device="cuda", generator=g)
    n = rotation(4 * rows * h * 2)
    pairs = [(randn(h, scale=3.0), randn(h)) for _ in range(n)]
    s, o = ef.add_rmsnorm(*pairs[0], w, eps)
    ps, po = ef.add_rmsnorm_plain(*pairs[0], w, eps)
    if not bits_equal(s, ps):
        raise AssertionError("add_rmsnorm: the residual differs from the "
                             "plain version's")
    err = ef.outputs_agree(o, po)
    must_fail(lambda: ef.outputs_agree(
        o, ef.add_rmsnorm_plain(pairs[0][0], None, w, eps)[1]),
        "add_rmsnorm against the norm without the add")
    del s, o, ps, po
    out["add_rmsnorm"] = {
        **kernel_plain_turns(lambda p: ef.add_rmsnorm(*p, w, eps),
                             lambda p: ef.add_rmsnorm_plain(*p, w, eps),
                             pairs),
        "bound_ms": (4 * rows * h * 2 + h * 4) / PEAK_BYTES * 1e3,
        "max_abs_err": err, "calls": n}
    del pairs

    # D2: RoPE on q and k of the fused q|k|v rows, in place; control: the
    # angles one position on
    cos, sin = ef.rope_table(4096, d, cfg.rope_theta, "cuda")
    n = rotation(2 * rows * heads * d * 2)
    xs = [randn(qkv_w) for _ in range(n)]
    got = ef.rope(xs[0].clone(), heads, d, cos, sin)
    if not bits_equal(got, ef.rope_plain(xs[0].clone(), heads, d, cos,
                                         sin)):
        raise AssertionError("rope differs from the plain version")
    if bits_equal(got, ef.rope_plain(xs[0].clone(), heads, d,
                                     cos[1:].contiguous(),
                                     sin[1:].contiguous())):
        raise AssertionError("control not caught: rope against the angles "
                             "one position on")
    del got
    out["rope"] = {
        **kernel_plain_turns(lambda x: ef.rope(x, heads, d, cos, sin),
                             lambda x: ef.rope_plain(x, heads, d, cos, sin),
                             xs),
        "bound_ms": (2 * rows * heads * d * 2
                     + 2 * DECODER_T * d // 2 * 4) / PEAK_BYTES * 1e3,
        "max_abs_err": 0.0, "calls": n}
    del xs

    # D3: SwiGLU over the fused gate|up rows; control: the halves swapped
    n = rotation(3 * rows * inter * 2)
    gus = [randn(2 * inter, scale=4.0) for _ in range(n)]
    got = ef.swiglu(gus[0])
    err = ef.outputs_agree(got, ef.swiglu_plain(gus[0]))
    must_fail(lambda: ef.outputs_agree(got, ef.swiglu_plain(
        torch.cat(gus[0].chunk(2, dim=-1)[::-1], dim=-1))),
        "swiglu against silu(up) * gate")
    del got
    out["swiglu"] = {
        **kernel_plain_turns(ef.swiglu, ef.swiglu_plain, gus),
        "bound_ms": 3 * rows * inter * 2 / PEAK_BYTES * 1e3,
        "max_abs_err": err, "calls": n}
    del gus
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(f"  {name} {DECODER_ROWS} x {DECODER_T}: == plain (control "
            f"caught); cold, in turns, {r['calls']} calls: kernel "
            f"{r['ms']:.4f} ms ({r['ms'] / r['bound_ms']:.2f}x the bytes "
            f"bound {r['bound_ms']:.4f}), plain {r['plain_ms']:.4f}; max "
            f"|d - plain| {r['max_abs_err']:.3g}")
    return out


def causal_gqa_vs_plain(g, cfg):
    """K6's causal grouped-query mode at 64 x 512 and 2 x 4,096 (the model
    card's limit), bf16, q, k, v read in place from the fused projection:
    against masked_attention_plain(causal=True) on the same inputs
    (attention_kernel.outputs_agree, the card tests' tolerance), the
    written-out attention without the causal mask a control it must
    catch; timed cold beside the products' bound (4 H D T (T + 1) / 2
    FLOPs a row at the bf16 peak), at 64 x 512 in turns with the plain
    version."""
    import torch
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(d)

    def qkv(B, T):
        x = torch.randn(B, T, (H + 2 * KV) * d, device="cuda",
                        generator=g).to(torch.bfloat16)
        return (x[..., :H * d].view(B, T, H, d),
                x[..., H * d:(H + KV) * d].view(B, T, KV, d),
                x[..., (H + KV) * d:].view(B, T, KV, d))

    def kernel(p):
        return ak.masked_attention(*p, None, scale, causal=True)

    def plain(p):
        return ak.masked_attention_plain(*p, None, scale, causal=True)
    out = {}
    for B, T in ((DECODER_ROWS, DECODER_T), (2, 4096)):
        if ak.pick_variant(T, d, torch.bfloat16, True) != "wgmma":
            raise AssertionError(f"K6 at T={T}: not 'wgmma'")
        n = rotation(B * T * (H + 2 * KV) * d * 2 * 2)
        inputs = [qkv(B, T) for _ in range(n)]
        got = kernel(inputs[0])
        err = ak.outputs_agree(got, plain(inputs[0]))
        must_fail(lambda: ak.outputs_agree(got, ak.masked_attention_plain(
            *inputs[0], None, scale, causal=False)),
            f"causal K6 at T={T} against attention without the mask")
        del got
        torch.cuda.empty_cache()
        r = ({**kernel_plain_turns(kernel, plain, inputs)}
             if T == DECODER_T else {"ms": rotating_ms(kernel, inputs)})
        r.update(bound_ms=4 * B * H * d * T * (T + 1) / 2 / PEAK_BF16_FLOPS
                 * 1e3, max_abs_err=err, calls=n)
        out[f"{B}x{T}"] = r
        plain_ms = (f", plain {r['plain_ms']:.4f}" if "plain_ms" in r
                    else "")
        log(f"  masked_attention causal GQA ({H} / {KV} heads, D={d}) "
            f"{B} x {T}: == plain (control caught); cold, {n} calls: "
            f"{r['ms']:.4f} ms ({r['ms'] / r['bound_ms']:.2f}x the "
            f"products' bound {r['bound_ms']:.4f}){plain_ms}; max |d - "
            f"plain| {err:.3g}")
        del inputs
        torch.cuda.empty_cache()
    return out


def decoder_path(cfg):
    """The decoder on its main path: E5EmbeddingGenerator for
    e5-mistral-7b-instruct (seeded 7.1B weights, all 32 layers) over 64
    documents at bucket 512, twice (the first call captures). D1-D3's and
    K6's launch counts are set to 0 just before and read after: per
    forward (the replays and each capture's warm-up forwards) 65 D1, 32
    D2, 32 D3 and 32 "wgmma" K6 launches; the second call's profiler
    counters the same for its one replay; a replay equal bit for bit to
    the same chunk's eager forward. Returns the launch counts, the
    forwards and one replay's ms."""
    import torch
    from neighborhoodwatch_tpu_torch.models import decoder as dec
    from neighborhoodwatch_tpu_torch.models import e5, graphed
    from neighborhoodwatch_tpu_torch.ops import attention_kernel as ak
    from neighborhoodwatch_tpu_torch.ops import encoder_fused as ef
    from neighborhoodwatch_tpu_torch.utils import profiling
    t = time.perf_counter()
    gen = e5.E5EmbeddingGenerator(dec.E5_MISTRAL, device="cuda")
    texts = bucket_texts(DECODER_ROWS, DECODER_T, np.random.default_rng(18))
    torch.cuda.synchronize()
    log(f"  e5-mistral-7b-instruct built (pretrained {gen.pretrained}): "
        f"{time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card")
    ef.reset_launches()
    reset_counts(ak.masked_attention)
    with graph_forwards() as fw:
        first = gen.generate_embedding(texts)
        with torch.profiler.profile():
            again = gen.generate_embedding(texts)
            counters = dict(profiling.records()["counters"])
    require_graphed(fw, "decoder path")
    n = fw["forwards"] + graphed.WARMUP * fw["captures"]
    got = {name: getattr(ef, name).launches for name in DECODER_KERNELS}
    got["causal"] = ak.masked_attention.launches_by_variant["wgmma"]
    want = {k: v * n for k, v in DECODER_PER_FORWARD.items()}
    if got != want or ak.masked_attention.launches != want["causal"]:
        raise AssertionError(f"decoder path: launched {got} (K6 "
                             f"{ak.masked_attention.launches_by_variant}), "
                             f"expected {want} ({n} forwards)")
    per = DECODER_PER_FORWARD
    want_c = {"decoder.forwards": 1, "decoder.rmsnorm": per["add_rmsnorm"],
              "decoder.rope": per["rope"], "decoder.swiglu": per["swiglu"],
              "attn.causal_launches": per["causal"],
              "attn.causal_launches.wgmma": per["causal"],
              "attn.causal_tiles": ak.causal_tiles(
                  DECODER_ROWS, DECODER_T, cfg.num_heads, "wgmma")
              * per["causal"]}
    if {k: counters.get(k) for k in want_c} != want_c:
        raise AssertionError(f"decoder path: one replay counted "
                             f"{counters}, expected {want_c}")
    if not np.array_equal(first, again):
        raise AssertionError("decoder path: two replays differ")
    ids, mask = gen.tokenizer(texts, max_length=gen.max_length)
    with graphed.forced_variant("eager"):
        eager = gen.generate_embedding(texts)
    if not np.array_equal(first, eager):
        raise AssertionError("decoder path: the replay differs from the "
                             "eager forward")
    g = gen.runner.graphs[(DECODER_ROWS, DECODER_T)]
    ms = event_ms(g.graph.replay)
    log(f"  decoder path: {n} forwards ({fw['forwards']} replays + "
        f"{graphed.WARMUP} x {fw['captures']} warm-up) launched {got}: "
        f"{per} a forward; one replay's counters {want_c}; replay == "
        f"eager bit for bit; one replay of 64 x {ids.shape[1]} "
        f"({int(mask.sum())} real tokens): {ms:.1f} ms")
    del gen, g
    torch.cuda.empty_cache()
    return {"launches": got, "forwards": n, "replay_ms": ms}


def phase_decoder():
    """Phase 18: D1-D3 and K6's causal grouped-query mode against their
    plain versions at e5-mistral-7b-instruct's widths, timed beside their
    bounds, then their launches on the decoder's main path; returns their
    records for the kernels line (ms, plain_ms and bound_ms at 64 x 512,
    launches on the path and a forward)."""
    import torch
    from neighborhoodwatch_tpu_torch.models import decoder as dec
    cfg = dec.DECODER_CONFIGS[dec.E5_MISTRAL]
    g = torch.Generator(device="cuda").manual_seed(18)
    passes = decoder_passes_vs_plain(g, cfg)
    attn = causal_gqa_vs_plain(g, cfg)
    path = decoder_path(cfg)
    no_jax = "the plain version (the JAX package has no decoder): "
    recs = [{"name": name, "route": "cuda",
             "source": "neighborhoodwatch_tpu_torch/csrc/decoder_passes.cu",
             "replaces": f"{no_jax}neighborhoodwatch_tpu_torch/ops/"
                         f"encoder_fused.py:{name}_plain",
             "launches": path["launches"][name],
             "launches_per_forward": DECODER_PER_FORWARD[name],
             "shape": f"{DECODER_ROWS}x{DECODER_T}", "bound_by": "bytes",
             "library_ms": None, **passes[name]}
            for name in DECODER_KERNELS]
    main = attn[f"{DECODER_ROWS}x{DECODER_T}"]
    recs.append({
        "name": "masked_attention.causal_gqa", "route": "cuda",
        "source": "neighborhoodwatch_tpu_torch/csrc/masked_attention.cu",
        "replaces": f"{no_jax}neighborhoodwatch_tpu_torch/ops/"
                    f"attention_kernel.py:masked_attention_plain",
        "launches": path["launches"]["causal"],
        "launches_per_forward": DECODER_PER_FORWARD["causal"],
        "shape": f"{DECODER_ROWS}x{DECODER_T}", "bound_by": "flops",
        "library_ms": None, **main, "shapes": attn})
    recs.append({"name": "decoder_forward", "route": "cuda",
                 "source": "neighborhoodwatch_tpu_torch/models/decoder.py",
                 "forwards": path["forwards"],
                 "replay_ms": path["replay_ms"]})
    return recs


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
    # what phases 11 and 12 read again: phase 3's result, the data
    # directories of phases 4, 7 and 8 (kept until the end) and phase 6's
    # stream
    kept, workdirs = {}, []

    def workdir():
        workdirs.append(tempfile.mkdtemp(prefix="nw_smoke_", dir=HERE))
        return workdirs[-1]

    try:
        t = time.perf_counter()
        card = phase_setup()
        log(f"phase 1 setup: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        worst = phase_kernel_vs_plain()
        log(f"phase 2 kernel vs plain: ok (max |d| {worst:.3g}), "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        kept["engine"] = phase_engine(rec)
        log(f"phase 3 engine 10k x 1M x 1536: ok, "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        kept["pipeline"] = phase_pipeline(rec, workdir())
        log(f"phase 4 pipeline: ok, {time.perf_counter() - t:.1f} s")
        mrec = {"name": "maxsim_keys", "route": "cuda",
                "source": "neighborhoodwatch_tpu_torch/csrc/maxsim_keys.cu",
                "replaces": "neighborhoodwatch_tpu/ops/maxsim_kernel.py:169"}
        t = time.perf_counter()
        worst = phase_maxsim_kernel_vs_plain()
        log(f"phase 5 maxsim kernel vs plain: ok (max |score| {worst:.3g}), "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        kept["maxsim_stream"] = phase_maxsim_engine(mrec)
        log(f"phase 6 maxsim engine 1k x 32 x 128 vs 200k x 16 and 50k x "
            f"64: ok, {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        kept["ck"] = phase_ck(mrec, workdir())
        log(f"phase 7 ck --maxsim: ok, {time.perf_counter() - t:.1f} s")
        nw_dir = workdir()
        t = time.perf_counter()
        files = phase_nw(rec, nw_dir, keep=kept)
        log(f"phase 8 nw e5-large-v2 1,000 x 100,000: ok, "
            f"{time.perf_counter() - t:.1f} s")
        kept["nw"] = {"workdir": nw_dir, "files": files, "k": 100,
                      "model": "intfloat/e5-large-v2",
                      **{key: rec["nw_shape"][key] for key in "QBD"}}
        t = time.perf_counter()
        phase_tools(rec, nw_dir, files)
        log(f"phase 9 nw-tools knn + recall: ok, "
            f"{time.perf_counter() - t:.1f} s")
        arec = {"name": "masked_attention", "route": "cuda",
                "source": "neighborhoodwatch_tpu_torch/csrc/"
                          "masked_attention.cu",
                "replaces": "neighborhoodwatch_tpu/models/bert_flax.py:110"}
        t = time.perf_counter()
        phase_attention(arec)
        log(f"phase 10 attention: ok, {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_mesh(rec, mrec, kept, workdir())
        log(f"phase 11 mesh: ok, {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_port(rec, arec, kept["engine"], workdir())
        log(f"phase 12 native fvec engine, nw-tools knn, screened_knn, "
            f"encoder probe: ok, {time.perf_counter() - t:.1f} s")
        vrec = {"name": "verified_select", "route": "cuda",
                "source": "neighborhoodwatch_tpu_torch/csrc/"
                          "verified_select.cu",
                "replaces": "neighborhoodwatch_tpu/ops/knn.py:59"}
        t = time.perf_counter()
        phase_verified(vrec, kept["nw"])
        log(f"phase 13 verified select: ok, {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_encoders(arec, kept.pop("e5"), workdir())
        log(f"phase 14 encoders' CUDA graphs: ok, "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        frecs = phase_fused(kept["nw"])
        log(f"phase 15 the kNN core's fused kernels: ok, "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        erecs = phase_encoder_fused()
        log(f"phase 16 the encoders' fused kernels: ok, "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        mrecs = phase_maxsim_fused()
        log(f"phase 17 the MaxSim engines' fused kernels: ok, "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        drecs = phase_decoder()
        log(f"phase 18 the decoder's kernels and main path: ok, "
            f"{time.perf_counter() - t:.1f} s")
    finally:
        for w in workdirs:
            shutil.rmtree(w, ignore_errors=True)
    assert "jax" not in sys.modules
    log(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": [rec, mrec, arec, vrec, *frecs, *erecs,
                                  *mrecs, *drecs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_RANK_FLAG]:
        mesh_rank_main(sys.argv[2:])
    else:
        main()
