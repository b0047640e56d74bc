"""`nw` and `ck` command-line entry points (counterpart of cli.py).

Flag parity with the JAX package's `nw` and `ck` (and so with the
reference neighborhoodwatch.py:42-61 and colbert_knn.py:155-172), plus
`--device` (default "cuda": the run raises without a card unless
`--device cpu` asks for the host). `nw --trace-dir` records a
torch.profiler trace of the kNN stage (utils/profiling.device_trace).

`--mesh N` shards the kNN (and `ck --maxsim`'s MaxSim) over N ranks, one
process and one device each (parallel/mesh.py): start the command under
`torchrun --nproc-per-node N -m neighborhoodwatch_tpu_torch.cli ...` (rank
r takes cuda:r, or the CPU under `--device cpu` over gloo); `--mesh 1`
without a launcher runs a single-rank group in process. N must equal the
launcher's world size. Rank 0 alone generates the embedding parquets (the
other ranks wait at a barrier, then find the files) and writes every
artifact after the kNN stage; every rank joins the kNN. `nw --mesh`
implies `--use-dataset-api`.
"""

import argparse
import logging
import os
import sys
import time
from datetime import datetime, timedelta


class KeepLineBreaksFormatter(argparse.RawTextHelpFormatter):
    pass


def _section(title):
    """Ruled, colored section header on a tty; plain marker otherwise
    (the reference renders rich Markdown banners/rules,
    neighborhoodwatch.py:69-84 — this is the dependency-free analog)."""
    import shutil
    if sys.stdout.isatty() and os.environ.get("TERM", "dumb") != "dumb":
        width = shutil.get_terminal_size((72, 20)).columns
        rule = "─" * max(0, min(width, 100) - len(title) - 4)
        print(f"\n\x1b[1;36m── {title} {rule}\x1b[0m")
    else:
        print(f"\n=== {title} ===")


def _duration(section_time, start_time):
    print(f"(Duration: {time.time() - section_time:.2f} s of "
          f"{time.time() - start_time:.2f} s total)")


def _confirm(prompt: str) -> bool:
    """y/n confirmation that survives non-interactive runs: a closed or
    non-tty stdin (nohup/cron) answers no instead of crashing with
    EOFError after an expensive generation run, and 'Y'/'YES' count
    (case/whitespace-insensitive)."""
    try:
        answer = input(prompt)
    except EOFError:
        print("  (stdin closed — skipping; pass --yes to confirm "
              "non-interactively)")
        return False
    return answer.strip().lower() in ("y", "yes")


# hours a rank waits in a collective (the barrier behind rank 0's
# embedding generation) before the group gives up
MESH_TIMEOUT_HOURS = 24


def _open_mesh(n: int, device):
    """`--mesh N` -> (mesh or None, this rank's device, whether this call
    made the process group and must close it). N larger than the world
    size exits with the reason."""
    import torch.distributed as dist
    from neighborhoodwatch_tpu_torch.parallel.mesh import make_mesh
    if not n:
        return None, device, False
    made = not dist.is_initialized()
    try:
        # rank 0 generates the embeddings while the others wait at a
        # barrier: the group's timeout must outlast the generation
        mesh = make_mesh(n, device=device,
                         timeout=timedelta(hours=MESH_TIMEOUT_HOURS))
    except ValueError as e:
        print(f"--mesh {n}: {e}")
        sys.exit(2)
    return mesh, mesh.device, made


def _mesh_label(mesh) -> str:
    if mesh is None:
        return "none (single device)"
    return (f"dp={mesh.dp} x mp={mesh.mp}, rank {mesh.rank}, "
            f"{mesh.backend}")


def _close_mesh(made: bool) -> None:
    import torch.distributed as dist
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _encoder_rate(generator, section_time):
    """Pipeline-level encoder throughput of one generation section
    (tokenize + encode + parquet write), from the generator's own token
    count."""
    wall = time.time() - section_time
    seen, generator.tokens_seen = generator.tokens_seen, 0
    if wall > 0:
        print(f"   encoder pipeline: {seen} tokens in {wall:.1f} s = "
              f"{seen / wall:.0f} tokens/s")


def nw_main(argv=None):
    from neighborhoodwatch_tpu_torch import resolve_device
    from neighborhoodwatch_tpu_torch.models.registry import (
        get_valid_model_names_string,
    )

    start_time = time.time()
    parser = argparse.ArgumentParser(
        description="nw (neighborhood watch, PyTorch/CUDA edition) generates "
                    "ground truth KNN datasets with exact brute-force search",
        epilog="""
Some example commands:\n
    nw 1000 10000 -k 100 -m 'intfloat/e5-small-v2'
    nw 1000 10000 -k 100 -m 'intfloat/e5-large-v2' --use-dataset-api
    nw 100 1000 -k 10 -m 'intfloat/e5-small-v2' --synthetic --device cpu
        """, formatter_class=KeepLineBreaksFormatter)
    parser.add_argument("query_count", type=int,
                        help="number of query vectors to generate")
    parser.add_argument("base_count", type=int,
                        help="number of base vectors to generate")
    parser.add_argument("-m", "--model_name", type=str,
                        help=f"model name, one of: {get_valid_model_names_string()}")
    parser.add_argument("-ods", "--output_dimension_size", type=int, default=None,
                        help="output dimension size (differs from model default "
                             "only for models that support reduction)")
    parser.add_argument("-odt", "--output_dtype", type=str, default="float",
                        help="output dtype; currently only valid for VoyageAI models")
    parser.add_argument("-k", "--k", type=int, default=100,
                        help="number of neighbors per query vector")
    parser.add_argument("--data-dir", type=str, default="knn_dataset",
                        help="directory for generated data (default: knn_dataset)")
    parser.add_argument("--use-dataset-api", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="stream the base corpus out-of-core (recommended "
                             "for large datasets)")
    parser.add_argument("--gen-hdf5", action=argparse.BooleanOptionalAction,
                        default=True, help="generate hdf5 files (default: True)")
    parser.add_argument("--post-validation", action=argparse.BooleanOptionalAction,
                        default=False, help="validate the generated files")
    parser.add_argument("--enable-memory-tuning", action="store_true",
                        help="derive batch sizes from the device memory "
                             "budget threshold")
    parser.add_argument("--disable-memory-tuning", action="store_false",
                        dest="enable_memory_tuning",
                        help="use default batch sizing")
    parser.add_argument("--metric", type=str, default="sqeuclidean",
                        choices=["sqeuclidean", "euclidean", "cosine", "dot"],
                        help="distance metric (sqeuclidean matches the "
                             "reference raft engine)")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["default", "high", "highest"],
                        help="exact and verified engines' product "
                             "precision: default = bf16 operands, high = "
                             "bf16x3, highest = full fp32 (the screened "
                             "engine re-ranks in fp32 at every setting)")
    parser.add_argument("--synthetic", action="store_true",
                        help="use synthetic source text (hermetic, no network)")
    parser.add_argument("--yes", action="store_true",
                        help="skip interactive confirmation prompts")
    parser.add_argument("--trace-dir", type=str, default=None,
                        help="write a torch.profiler trace of the kNN phase "
                             "here (a Chrome trace JSON file)")
    parser.add_argument("--engine", type=str, default="auto",
                        choices=["auto", "exact", "verified", "screened"],
                        help="kNN engine: exact (the oracle), verified (the "
                             "exact tiles with the hand-written verified "
                             "select: candidates, count proof, exact "
                             "fallback), screened (the hand-written screen "
                             "kernel + certificate + repair), auto (on the "
                             "card screened for bases of >= 2 mega-tiles, "
                             "verified below; exact on the CPU)")
    parser.add_argument("--screen-precision", type=str, default="auto",
                        choices=["auto", "default", "medium", "high"],
                        help="screened engine's tensor-core pass count: "
                             "high=bf16x3, medium=bf16x2, default=bf16, "
                             "auto (the default) = lean 1-pass plan with "
                             "adaptive streaming escalation; every tier is "
                             "exact via the certificate + repair")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="shard the kNN over an N-device mesh (base "
                             "batches split over N ranks, one process and "
                             "one device each: run under torchrun "
                             "--nproc-per-node N; 1 runs in process); "
                             "implies --use-dataset-api; 0 = single device")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the encoder and the engines "
                             "(default: cuda; raises without a card unless "
                             "'cpu' is asked for)")
    args = parser.parse_args(argv)
    if args.mesh:
        args.use_dataset_api = True
    mesh, device, made = _open_mesh(args.mesh, resolve_device(args.device))
    try:
        _nw(args, device, mesh, start_time)
    finally:
        _close_mesh(made)


def _nw(args, device, mesh, start_time):
    from neighborhoodwatch_tpu_torch.core.merge import merge_indices_and_distances
    from neighborhoodwatch_tpu_torch.core.pipeline import compute_knn, compute_knn_ds
    from neighborhoodwatch_tpu_torch.data import sources
    from neighborhoodwatch_tpu_torch.io.export import generate_output_files
    from neighborhoodwatch_tpu_torch.io.parquet_io import cleanup_partial_parquet
    from neighborhoodwatch_tpu_torch.models.registry import (
        EmbeddingModelName, get_effective_embedding_size,
        get_valid_model_names_string, is_valid_model_name,
        local_weight_status,
    )
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.utils.profiling import device_trace
    from neighborhoodwatch_tpu_torch.validate import validate_files_v0

    rank0 = mesh is None or mesh.rank == 0
    assert is_valid_model_name(args.model_name), \
        f"unknown embedding model {args.model_name!r}; supported: {get_valid_model_names_string()}"
    if args.model_name == EmbeddingModelName.COLBERT_V2.value:
        raise SystemExit("For the ColBERT model, use the `ck` program")

    if not args.synthetic and not sources.check_dataset_exists_remote():
        print(f"The wikipedia dataset configuration does not exist/is not "
              f"reachable: {naming.BASE_CONFIG}")
        sys.exit(1)

    print(f"""Neighborhood Watch (PyTorch/CUDA) generating brute force neighbors:
  source dataset:      {'synthetic' if args.synthetic else naming.BASE_DATASET + '-' + naming.BASE_CONFIG}
  query count:         {args.query_count}
  base vector count:   {args.base_count}
  model name:          {args.model_name}
  output dimensions:   {args.output_dimension_size}
  output dtype:        {args.output_dtype}
  K:                   {args.k}
  dataset API:         {args.use_dataset_api}
  hdf5:                {args.gen_hdf5}
  post validation:     {args.post_validation}
  memory tuning:       {args.enable_memory_tuning}
  metric/precision:    {args.metric}/{args.precision}
  device:              {device}
  mesh:                {_mesh_label(mesh)}
  model weights:       {local_weight_status(args.model_name)}""")

    model_prefix = naming.get_model_prefix(args.model_name)
    # synthetic smoke runs get their own artifact tree: the resume-by-
    # artifact guards key on filenames only, so a later REAL run in the
    # same tree would silently reuse synthetic-text embeddings as
    # published ground truth
    tree_name = args.model_name + ("_synthetic" if args.synthetic else "")
    data_dir = naming.setup_model_output_folder(
        args.data_dir, tree_name, args.query_count, args.base_count, args.k)
    output_dimension = get_effective_embedding_size(args.model_name,
                                                    args.output_dimension_size)
    output_dtype = None
    if args.model_name.startswith("voyage"):
        output_dtype = args.output_dtype
        assert output_dtype in ["float", "int8", "uint8", "binary", "ubinary"]

    if rank0:
        _section("Generating query dataset")
        section_time = time.time()
        qsource = sources.load_query_source(
            synthetic_rows=args.query_count * 3 if args.synthetic else None)
        sources.generate_query_dataset(
            data_dir, args.model_name, args.query_count, output_dimension,
            output_dtype, source=qsource, device=device)
        _duration(section_time, start_time)

        _section("Generating base dataset")
        section_time = time.time()
        bsource = sources.load_base_source(
            synthetic_rows=args.base_count * 3 if args.synthetic else None)
        sources.generate_base_dataset(
            data_dir, args.model_name, naming.get_source_query_dataset_filename(
                data_dir, args.model_name, args.query_count,
                output_dimension, output_dtype),
            args.base_count, output_dimension, output_dtype, source=bsource,
            device=device)
        _duration(section_time, start_time)

        cleanup_partial_parquet(f"{data_dir}/partial")
    if mesh is not None:
        mesh.barrier()     # the other ranks read rank 0's parquet files
    query_filename = naming.get_source_query_dataset_filename(
        data_dir, args.model_name, args.query_count, output_dimension,
        output_dtype)
    base_filename = naming.get_source_base_dataset_filename(
        data_dir, args.model_name, args.base_count, output_dimension,
        output_dtype)

    _section("Computing knn")
    section_time = time.time()
    with device_trace(args.trace_dir):
        if args.use_dataset_api:
            timer = compute_knn_ds(data_dir, output_dimension, query_filename,
                                   args.query_count, base_filename,
                                   args.base_count, args.enable_memory_tuning,
                                   args.k, metric=args.metric,
                                   precision=args.precision,
                                   mesh=mesh, engine=args.engine,
                                   screen_precision=args.screen_precision,
                                   device=device)
        else:
            timer = compute_knn(data_dir, args.model_name, output_dimension,
                                query_filename, args.query_count, base_filename,
                                args.base_count, args.enable_memory_tuning,
                                args.k, metric=args.metric,
                                precision=args.precision, engine=args.engine,
                                screen_precision=args.screen_precision,
                                device=device)
    print(timer.report())
    _duration(section_time, start_time)
    if not rank0:
        return          # rank 0 writes every artifact from here on

    _section("Merging indices and distances")
    section_time = time.time()
    merge_indices_and_distances(data_dir, k=args.k, device=device)
    _duration(section_time, start_time)

    _section("Generating ivec's and fvec's")
    section_time = time.time()
    query_fvec, base_fvec, indices_ivec, distances_fvec = generate_output_files(
        data_dir, model_prefix, output_dimension, base_filename, query_filename,
        args.base_count, args.query_count,
        naming.get_partial_indices_filename(data_dir, -1),
        naming.get_partial_distances_filename(data_dir, -1),
        args.k, args.gen_hdf5, column_names=None, output_dtype=output_dtype)
    _duration(section_time, start_time)

    if args.post_validation:
        proceed = args.yes or _confirm(
            "Dataset validation may take a long time. "
            "Continue? (y/n/yes/no): ")
        if proceed:
            _section("Validating ivec's and fvec's")
            section_time = time.time()
            validate_files_v0(data_dir, query_fvec, base_fvec, indices_ivec,
                              distances_fvec, metric=args.metric,
                              device=device)
            _duration(section_time, start_time)


def ck_main(argv=None):
    from neighborhoodwatch_tpu_torch import resolve_device

    start_time = time.time()
    parser = argparse.ArgumentParser(
        description="ck (ColBERT KNN, PyTorch/CUDA edition) generates "
                    "ground truth KNN datasets with per-token ColBERT "
                    "embeddings",
        epilog="""
Some example commands:\n
    ck 100000 1000000 -k 100
    ck 1000 10000 -k 10 --synthetic
        """, formatter_class=KeepLineBreaksFormatter)
    parser.add_argument("query_token_count", type=int,
                        help="number of query token vectors to generate")
    parser.add_argument("base_token_count", type=int,
                        help="number of base token vectors to generate")
    parser.add_argument("-m", "--model_name", type=str, default="colbertv2.0",
                        help="ColBERT model name (default: colbertv2.0)")
    parser.add_argument("-k", "--k", type=int, default=100,
                        help="number of neighbors per query token")
    parser.add_argument("-es", "--embedding-scale", type=str, default="medium",
                        help="embedding scale: small (10000), medium (100000), "
                             "large (1000000)")
    parser.add_argument("--data-dir", type=str, default="knn_dataset")
    parser.add_argument("--use-dataset-api", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="reference-parity flag (colbert_knn.py:164,189 "
                             "reports it without changing behavior); the "
                             "token kNN always streams the base out-of-core "
                             "(the dataset-API behavior is the only path)")
    parser.add_argument("--gen-hdf5", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--enable-memory-tuning", action="store_true")
    parser.add_argument("--disable-memory-tuning", action="store_false",
                        dest="enable_memory_tuning")
    parser.add_argument("--metric", type=str, default="dot",
                        choices=["sqeuclidean", "euclidean", "cosine", "dot"],
                        help="token distance metric (dot matches the "
                             "reference torch engine)")
    parser.add_argument("--engine", type=str, default="auto",
                        choices=["auto", "exact", "verified", "screened"],
                        help="kNN engine for the flat token path (the "
                             "reference's raft/cuvs/torch choice maps to "
                             "one exact engine family)")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["default", "high", "highest"])
    parser.add_argument("--screen-precision", type=str, default=None,
                        choices=["auto", "default", "medium", "high"],
                        help="screened engine's tensor-core pass tier "
                             "(every tier is exact via the certificates + "
                             "repair). Default: 'auto' — the flat token "
                             "kNN runs the lean 1-pass plan with adaptive "
                             "escalation, and --maxsim streams run the "
                             "adaptive controller (start at the 3-pass "
                             "tier, downshift when the batch diagnostics "
                             "predict a cheaper tier certifies, "
                             "re-escalate on failures); pin a tier to opt "
                             "out")
    parser.add_argument("--synthetic", action="store_true",
                        help="use synthetic source text (hermetic, no network)")
    parser.add_argument("--maxsim", action="store_true",
                        help="doc-level MaxSim ground truth (proper ColBERT "
                             "late interaction) instead of the reference's "
                             "flat token-vs-token kNN; neighbor indices are "
                             "base passage ids and distances are negative "
                             "MaxSim scores")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="shard the kNN/MaxSim over an N-device mesh "
                             "(token batches / doc tiles split over N ranks, "
                             "one process and one device each: run under "
                             "torchrun --nproc-per-node N; 1 runs in "
                             "process); 0 = single device")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the encoder and the engines "
                             "(default: cuda; raises without a card unless "
                             "'cpu' is asked for)")
    parser.add_argument("--post-validation", action="store_true",
                        help="validate the written artifacts: flat token "
                             "mode recomputes similarities from the files "
                             "(validate_files_v0); --maxsim mode recomputes "
                             "MaxSim scores in float64 from the fvec + "
                             "doc-id-map artifacts alone "
                             "(validate_maxsim_files)")
    parser.add_argument("--yes", "-y", action="store_true",
                        help="skip the validation confirmation prompt")
    args = parser.parse_args(argv)

    if args.screen_precision is None:
        # "auto" everywhere: the kNN paths run the lean 1-pass ladder, and
        # the MaxSim streams run the adaptive controller
        # (ops.maxsim.MaxSimTierController)
        args.screen_precision = "auto"

    mesh, device, made = _open_mesh(args.mesh, resolve_device(args.device))
    try:
        _ck(args, device, mesh, start_time)
    finally:
        _close_mesh(made)


def _ck(args, device, mesh, start_time):
    from neighborhoodwatch_tpu_torch.core.colbert_pipeline import (
        compute_maxsim_knn, print_dataset_info, process_knn_computation,
        process_source_dataset,
    )
    from neighborhoodwatch_tpu_torch.core.merge import merge_indices_and_distances
    from neighborhoodwatch_tpu_torch.data import sources
    from neighborhoodwatch_tpu_torch.io.export import generate_output_files
    from neighborhoodwatch_tpu_torch.io.parquet_io import (
        ParquetStreamer, cleanup_partial_parquet,
    )
    from neighborhoodwatch_tpu_torch.models.colbert import ColbertEmbeddingGenerator
    from neighborhoodwatch_tpu_torch.models.registry import (
        EmbeddingModelName, colbert_weight_status,
        get_effective_embedding_size,
    )
    from neighborhoodwatch_tpu_torch.utils import naming

    rank0 = mesh is None or mesh.rank == 0
    assert args.model_name == EmbeddingModelName.COLBERT_V2.value, \
        "`ck` program is reserved for the ColBERT model"

    if not args.synthetic and not sources.check_dataset_exists_remote():
        print(f"The wikipedia dataset configuration does not exist/is not "
              f"reachable: {naming.BASE_CONFIG}")
        sys.exit(1)

    model_prefix = naming.get_model_prefix(args.model_name)
    # distinct artifact trees per mode: the flat and --maxsim exports share
    # every ivec/fvec/hdf5 filename, so the idempotent already-exists
    # skips would silently publish the OTHER mode's neighbors/distances
    # under maxsim semantics attrs (and vice versa); synthetic smoke runs
    # likewise must never be resumable as real ground truth
    tree_name = (args.model_name
                 + ("_maxsim" if args.maxsim else "")
                 + ("_synthetic" if args.synthetic else ""))
    data_dir = naming.setup_model_output_folder(
        args.data_dir, tree_name, args.query_token_count,
        args.base_token_count, args.k)
    input_dimensions = get_effective_embedding_size(args.model_name)

    scale_map = {"small": 10_000, "medium": 100_000, "large": 1_000_000}
    if args.embedding_scale not in scale_map:
        print(f"Invalid embedding scale: {args.embedding_scale}")
        sys.exit(1)
    embedding_chunk_size = scale_map[args.embedding_scale]

    # the reference reports this flag without acting on it
    # (colbert_knn.py:189); the token kNN always streams the base
    print(f"  dataset API:         {args.use_dataset_api} "
          "(token kNN always streams out-of-core)")
    print(f"  mesh:                {_mesh_label(mesh)}")
    token_generator = None
    if rank0:       # the only rank that encodes
        token_generator = ColbertEmbeddingGenerator(
            chunk_size=embedding_chunk_size, device=device)
        print("  model weights:       "
              + colbert_weight_status(token_generator.head_pretrained,
                                      token_generator.pretrained))

    handlers = [logging.StreamHandler()]
    if rank0:
        handlers.insert(0, logging.FileHandler(
            f"{data_dir}/colbert_knn_{datetime.now().strftime('%Y-%m-%d-%H-%M-%S')}.log",
            mode="w"))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(filename)s:%(lineno)s - %(funcName)20s() - "
               "%(levelname)s] %(message)s",
        handlers=handlers)
    logger = logging.getLogger(__name__)

    token_embed_columns = [f"token_embedding_{i}" for i in range(input_dimensions)]

    marker = "_docs" if args.maxsim else ""

    _section("Generating query dataset with embeddings")
    section_time = time.time()
    query_file = f"{data_dir}/{model_prefix}_{input_dimensions}_query_token{args.query_token_count}{marker}_src.parquet"
    # footer-validating resume guard (sources._valid_parquet): a killed
    # embedding run leaves a footerless parquet that a bare exists() check
    # would reuse forever, wedging every later ck run. Rank 0 alone
    # generates; the other ranks find its files after the barrier below
    if rank0 and not sources._valid_parquet(query_file):
        src = sources.load_query_source(
            synthetic_rows=args.query_token_count if args.synthetic else None)
        streamer = ParquetStreamer(query_file, token_embed_columns)
        stats = process_source_dataset(streamer, token_generator, src,
                                       input_dimensions, args.query_token_count,
                                       "question", logger=logger,
                                       track_docs=args.maxsim)
        # abort-don't-publish on an undersized token stream: a published
        # short parquet would pass the resume guard and be silently reused
        # by every later run while the artifact names claim the full count
        # (the token analog of sources.py's processed == row_count assert
        # inside the publish block)
        if stats[2] != args.query_token_count:
            streamer.abort()
            raise AssertionError(
                f"query source exhausted at {stats[2]} tokens "
                f"(requested {args.query_token_count}); nothing published")
        streamer.close()
        print_dataset_info("query", args.query_token_count, *stats)
        _encoder_rate(token_generator, section_time)
    elif rank0:
        print("The source query embed file already exists, skipping.")
    _duration(section_time, start_time)

    _section("Generating base dataset with embeddings")
    section_time = time.time()
    base_file = f"{data_dir}/{model_prefix}_{input_dimensions}_base_token{args.base_token_count}{marker}_src.parquet"
    if rank0 and not sources._valid_parquet(base_file):   # see query_file
        src = sources.load_base_source(
            synthetic_rows=args.base_token_count if args.synthetic else None)
        streamer = ParquetStreamer(base_file, token_embed_columns)
        stats = process_source_dataset(streamer, token_generator, src,
                                       input_dimensions, args.base_token_count,
                                       "text", logger=logger,
                                       track_docs=args.maxsim)
        if stats[2] != args.base_token_count:   # see query-side note
            streamer.abort()
            raise AssertionError(
                f"base source exhausted at {stats[2]} tokens "
                f"(requested {args.base_token_count}); nothing published")
        streamer.close()
        print_dataset_info("base", args.base_token_count, *stats)
        _encoder_rate(token_generator, section_time)
    elif rank0:
        print("The source base embed file already exists, skipping.")
    _duration(section_time, start_time)

    if rank0:
        cleanup_partial_parquet(f"{data_dir}/partial")
    if mesh is not None:
        mesh.barrier()

    if args.maxsim:
        _section("Computing doc-level MaxSim ground truth")
        section_time = time.time()
        timer, n_q_docs, n_b_docs = compute_maxsim_knn(
            data_dir, query_file, base_file, k=args.k,
            precision=args.precision, mesh=mesh,
            screen_precision=args.screen_precision, device=device)
        print(timer.report())
        print(f"MaxSim: {n_q_docs} query passages x {n_b_docs} base passages")
        _duration(section_time, start_time)
    else:
        _section("Computing knn")
        section_time = time.time()
        timer = process_knn_computation(
            data_dir, base_file, args.base_token_count,
            query_file, args.query_token_count,
            mem_tune=args.enable_memory_tuning,
            k=args.k, metric=args.metric,
            precision=args.precision, engine=args.engine, mesh=mesh,
            screen_precision=args.screen_precision, device=device)
        print(timer.report())
        _duration(section_time, start_time)
    if not rank0:
        return          # rank 0 writes every artifact from here on

    if not args.maxsim:
        _section("Merging indices and distances")
        section_time = time.time()
        merge_indices_and_distances(data_dir, k=args.k, device=device)
        _duration(section_time, start_time)

    _section("Generating ivec's and fvec's")
    section_time = time.time()
    (query_fvec, base_fvec, indices_ivec,
     distances_fvec) = generate_output_files(
        data_dir, model_prefix, input_dimensions, base_file,
        query_file, args.base_token_count,
        args.query_token_count,
        naming.get_partial_indices_filename(data_dir, -1),
        naming.get_partial_distances_filename(data_dir, -1),
        args.k, args.gen_hdf5, token_embed_columns)
    if args.maxsim:
        # neighbors/distances are per query *passage*: also export the
        # token->passage maps so the artifact set is self-contained
        from neighborhoodwatch_tpu_torch.io.export import export_maxsim_doc_maps
        n_q_docs, n_b_docs = export_maxsim_doc_maps(
            data_dir, model_prefix, input_dimensions, query_file, base_file,
            args.base_token_count, args.query_token_count, args.k,
            args.gen_hdf5)
        print(f"  doc-id maps: {n_q_docs} query passages, "
              f"{n_b_docs} base passages")
    _duration(section_time, start_time)

    if args.post_validation:
        proceed = args.yes or _confirm(
            "Dataset validation may take a long time. "
            "Continue? (y/n/yes/no): ")
        if proceed:
            _section("Validating ivec's and fvec's")
            section_time = time.time()
            if args.maxsim:
                from neighborhoodwatch_tpu_torch.validate import validate_maxsim_files
                q_map_file, b_map_file = naming.get_doc_id_map_filenames(
                    data_dir, model_prefix, input_dimensions,
                    args.base_token_count, args.query_token_count)
                mismatches = validate_maxsim_files(
                    data_dir, query_fvec, base_fvec, q_map_file, b_map_file,
                    indices_ivec, distances_fvec)
            else:
                from neighborhoodwatch_tpu_torch.validate import validate_files_v0
                mismatches = validate_files_v0(
                    data_dir, query_fvec, base_fvec, indices_ivec,
                    distances_fvec, metric=args.metric, device=device)
            logger.info(f"post-validation mismatch count: {mismatches}")
            _duration(section_time, start_time)


if __name__ == "__main__":
    # python -m neighborhoodwatch_tpu_torch.cli [ck] ARGS: `nw`, or `ck`
    # (the module form is what torchrun starts under --mesh N)
    if sys.argv[1:2] == ["ck"]:
        ck_main(sys.argv[2:])
    else:
        nw_main()
