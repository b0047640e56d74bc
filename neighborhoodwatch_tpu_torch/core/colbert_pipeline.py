"""ColBERT (`ck`) pipeline (counterpart of core/colbert_pipeline.py):
per-token embedding streaming, token kNN and doc-level MaxSim.

Capability parity with reference colbert_knn.py:31-126: streams source
rows, sentencizes, encodes passages to per-token 128-d embeddings, writes
embedding-only parquet rows until the requested token count, then runs
either the token-vs-token kNN (the reference's flat approximation of
ColBERT retrieval) or the exact late-interaction MaxSim ground truth
(ops/maxsim.py) over doc-tracked token rows.

With a `mesh` (parallel/mesh.make_mesh; every rank runs the call), the
token kNN batches and the MaxSim doc tiles are split over the mesh's "mp"
axis, and rank 0 alone writes the checkpoints and the final files.
"""

import os

import numpy as np
import pyarrow.parquet as pq
import torch

from neighborhoodwatch_tpu_torch import resolve_device

from neighborhoodwatch_tpu_torch.core.pipeline import compute_knn_ds
from neighborhoodwatch_tpu_torch.data.sources import split_into_sentences
from neighborhoodwatch_tpu_torch.io.parquet_io import table_to_matrix
from neighborhoodwatch_tpu_torch.parallel.mesh import check_mesh
from neighborhoodwatch_tpu_torch.utils.misc import round_up


def process_source_dataset(streamer, generator, dataset, input_dimensions,
                           token_count, column_to_embed, logger=None,
                           track_docs=False):
    """Stream per-token embeddings to parquet until `token_count` tokens
    (reference: colbert_knn.py:31-81). With `track_docs`, every token row
    additionally carries the int32 id of the passage (encoded sentence) it
    came from, enabling doc-level MaxSim scoring downstream. Returns
    (rows_read, sentence_count, token_count_written, zero_embedding_count)."""
    processed_tokens = 0
    zero_text_embeddings = 0
    total_sentences = 0
    cur_row = 0
    token_rows: list[np.ndarray] = []
    doc_ids: list[np.ndarray] = []

    def flush():
        toks = np.concatenate(token_rows, axis=0)
        if track_docs:
            streamer.stream_tokens_with_doc_ids(
                toks, np.concatenate(doc_ids, axis=0))
        else:
            streamer.stream_to_parquet_without_src_metadata(toks)

    for cur_row, row in enumerate(dataset, start=1):
        sentence_list = split_into_sentences(row[column_to_embed])
        if not sentence_list:
            continue
        embeddings, counts = generator.generate_embedding(sentence_list)
        # the generator contract is ([flat tokens of ALL sentences], counts
        # per sentence) — reference model_generator.py:433-439; split the
        # flat stream back into per-sentence passages so each sentence gets
        # its own doc id (one wikipedia article is many passages, not one).
        # embeddings is normally one flat (N, d) array: reshape, never
        # iterate rows (a per-row concatenate costs millions of tiny
        # allocations). A generator honoring the list-of-arrays contract
        # (possibly ragged per sentence) is concatenated once per call.
        if isinstance(embeddings, (list, tuple)) and len(embeddings) > 1:
            flat = np.concatenate(
                [np.asarray(e, np.float32).reshape(-1, input_dimensions)
                 for e in embeddings], axis=0)
        else:
            flat = np.asarray(embeddings, dtype=np.float32) \
                .reshape(-1, input_dimensions)
        assert len(flat) == sum(counts), \
            f"token stream length {len(flat)} != sum of counts {sum(counts)}"
        for passage in np.split(flat, np.cumsum(counts)[:-1]):
            if not np.any(passage):
                zero_text_embeddings += 1
                continue
            take = min(len(passage), token_count - processed_tokens)
            token_rows.append(passage[:take])
            doc_ids.append(np.full(take, total_sentences, dtype=np.int32))
            processed_tokens += take
            total_sentences += 1
            if processed_tokens >= token_count:
                break
        # flush periodically to bound memory
        if sum(len(t) for t in token_rows) >= 100_000:
            flush()
            token_rows, doc_ids = [], []
        if processed_tokens >= token_count:
            break

    if token_rows:
        if logger is not None:
            logger.info(f"[final] processed_token_embedding_cnt: {processed_tokens}")
        flush()
    return cur_row, total_sentences, processed_tokens, zero_text_embeddings


def process_knn_computation(data_dir, base_filename, base_count, query_filename,
                            query_count, mem_tune=False,
                            initial_batch_size=1_000_000,
                            max_memory_threshold=0.1, k=100,
                            metric="dot", precision="highest",
                            engine="auto", mesh=None,
                            screen_precision="auto", device=None):
    """Token-vs-token exact kNN (reference: colbert_knn.py:84-126, which
    defaults to the torch `1 - matmul` engine — metric='dot' here).

    Uses the streaming dataset path: no partial files, device-merged
    finals. With `mesh`, token batches split over the mp axis."""
    return compute_knn_ds(data_dir, 128, query_filename, query_count,
                          base_filename, base_count, mem_tune=mem_tune, k=k,
                          initial_batch_size=initial_batch_size,
                          max_memory_threshold=max_memory_threshold,
                          metric=metric, precision=precision, engine=engine,
                          mesh=mesh, screen_precision=screen_precision,
                          device=device)


def _split_by_doc(tokens: np.ndarray, doc_ids: np.ndarray):
    """(n, d) tokens + ascending (n,) doc ids -> list of per-doc arrays."""
    if len(doc_ids) == 0:
        return []
    bounds = np.nonzero(np.diff(doc_ids))[0] + 1
    return np.split(tokens, bounds)


def _read_doc_tokens(filename: str):
    """Read a doc-tracked token parquet -> (token matrix, doc_ids)."""
    table = pq.read_table(filename)
    assert "doc_id" in table.schema.names, \
        f"{filename} lacks a doc_id column — regenerate with --maxsim"
    doc_ids = table.column("doc_id").to_numpy()
    embed_cols = [n for n in table.schema.names if n != "doc_id"]
    return table_to_matrix(table, embed_cols), doc_ids


def compute_maxsim_knn(data_dir, query_filename, base_filename, k,
                       tile_docs=None, precision="highest",
                       batch_rows=500_000, checkpoint_every=2, mesh=None,
                       screen_precision="auto", device=None):
    """Doc-level ColBERT MaxSim ground truth: for every query passage,
    the top-k base passages by sum-of-max token similarity.

    Base token rows are streamed, grouped into passages on the doc_id
    column, padded per tile to a multiple of 16 tokens and merged on the
    device through StreamingMaxSim (tiles of 8192 docs: one mega-tile of
    the screen kernel; the last tile's doc axis is padded to the same
    8192 rows with masked docs, so on a card every tile launches it).
    With `mesh`, through ShardedStreamingMaxSim in tiles of 8192 x mp docs
    (one mega-tile per shard, else every shard would run the exact
    scorer); every rank reads the parquet and builds the tile, and ships
    only its own docs to its device (the mesh's device, not `device`).

    Every `checkpoint_every` parquet batches the running (score, idx,
    docs_seen) state checkpoints to partial/stream_state.npz (the same
    fingerprinted format as compute_knn_ds and the JAX package); an
    interrupted run resumes, re-reading only docs >= the checkpointed
    count (doc ids are dense ascending, and docs are always emitted
    whole). 0 disables.

    Writes final_{indices,distances} parquet where indices are base *doc*
    ids and distances are **negative MaxSim scores** (ascending distance ==
    best-first, preserving the pipeline's distance contract).

    Backpressure: a CUDA event is recorded after each parquet batch and
    the host waits on the PREVIOUS batch's event before decoding further
    (the screened engine also copies its certificate to the host once per
    tile)."""
    from neighborhoodwatch_tpu_torch.core.pipeline import (
        _load_stream_ckpt, _save_stream_ckpt, _stream_ckpt_path,
    )
    from neighborhoodwatch_tpu_torch.io.parquet_io import (
        write_matrix_to_parquet,
    )
    from neighborhoodwatch_tpu_torch.ops.maxsim import (
        StreamingMaxSim, pad_token_lists,
    )
    from neighborhoodwatch_tpu_torch.utils import naming
    from neighborhoodwatch_tpu_torch.utils.profiling import StageTimer

    check_mesh(mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0
    timer = StageTimer()
    if tile_docs is None:
        tile_docs = 8192 * (1 if mesh is None else mesh.mp)
    with timer.stage("load_queries"):
        q_mat, q_ids = _read_doc_tokens(query_filename)
        q_docs = _split_by_doc(q_mat, q_ids)
        dim = q_mat.shape[1]
        queries, q_mask = pad_token_lists(q_docs, dim)

    if mesh is None:
        engine = StreamingMaxSim(queries, q_mask, k=k, precision=precision,
                                 screen_precision=screen_precision,
                                 device=dev)
        q_pad = engine.state[0].shape[0]
    else:
        from neighborhoodwatch_tpu_torch.parallel.sharded_maxsim import (
            ShardedStreamingMaxSim,
        )
        engine = ShardedStreamingMaxSim(queries, q_mask, k=k, mesh=mesh,
                                        precision=precision,
                                        screen_precision=screen_precision)
        q_pad = engine.q_pad

    ckpt_path = _stream_ckpt_path(data_dir)
    st = os.stat(base_filename)
    stq = os.stat(query_filename)
    fingerprint = {"f_mode": "maxsim", "f_k": k, "f_base": base_filename,
                   "f_q": len(q_docs), "f_dims": dim,
                   # a mesh pads the query rows to dp: only a run of
                   # the same padded shape can restore
                   "f_qpad": q_pad,
                   # precision changes the scoring arithmetic
                   "f_prec": precision,
                   # content identity of the base and query files
                   "f_bsize": st.st_size,
                   "f_bmtime": round(st.st_mtime, 3),
                   "f_qsize": stq.st_size,
                   "f_qmtime": round(stq.st_mtime, 3)}
    done_docs = 0
    if checkpoint_every:
        saved = _load_stream_ckpt(ckpt_path, fingerprint)
        if saved is not None:
            engine.restore(*saved)
            done_docs = engine.docs_seen
            print(f"resuming MaxSim stream from checkpoint: "
                  f"{done_docs} base docs done")

    pf = pq.ParquetFile(base_filename)
    pending_docs: list[np.ndarray] = []   # complete, not yet tiled
    leftover: np.ndarray | None = None    # tokens of the trailing open doc
    leftover_id = None

    def emit_tiles(docs, final=False):
        while len(docs) >= tile_docs or (final and docs):
            chunk, docs = docs[:tile_docs], docs[tile_docs:]
            n_valid = len(chunk)
            if n_valid < tile_docs:       # pad the last tile's doc axis
                chunk = chunk + [np.zeros((1, dim), np.float32)] * \
                    (tile_docs - n_valid)
            td = round_up(max(len(c) for c in chunk[:n_valid]), 16)
            tile, tmask = pad_token_lists(chunk, dim, max_tokens=td)
            if n_valid < tile_docs:
                tmask[n_valid:] = False
            engine.update(tile, tmask, n_valid=n_valid)
        return docs

    with timer.stage("stream_base"):
        prev_event = None
        # resume: skip whole row groups whose doc_id statistics prove every
        # row is checkpoint-covered. Groups without statistics are
        # conservatively included; the in-loop trim still handles a group
        # that straddles done_docs. A doc with id >= done_docs cannot START
        # in a skipped group: that group's max would be >= done_docs.
        if done_docs:
            md = pf.metadata
            ci = pf.schema_arrow.names.index("doc_id")
            sel = []
            for g in range(md.num_row_groups):
                stats = md.row_group(g).column(ci).statistics
                if stats is None or not stats.has_min_max \
                        or stats.max >= done_docs:
                    sel.append(g)
            batches = (pf.iter_batches(batch_size=batch_rows, row_groups=sel)
                       if sel else iter(()))
        else:
            batches = pf.iter_batches(batch_size=batch_rows)
        for b, batch in enumerate(batches):
            if batch.num_rows == 0:
                # an empty row group must not reach the leftover handling
                # below: its empty id array looks like "a new doc started"
                # and would flush the open trailing doc prematurely
                continue
            id_col = batch.schema.get_field_index("doc_id")
            # get_field_index returns -1 (silently the LAST embedding
            # column via column(-1)) for a file without doc tracking
            assert id_col >= 0, (
                f"{base_filename} has no doc_id column — regenerate the "
                f"base token parquet with --maxsim (doc-tracked rows)")
            ids = batch.column(id_col).to_numpy()
            if done_docs and ids[-1] < done_docs:
                continue                  # fully covered by the checkpoint
            cols = [n for n in batch.schema.names if n != "doc_id"]
            mat = table_to_matrix(batch, cols)
            if done_docs and ids[0] < done_docs:
                # partial overlap: docs are emitted whole, so drop every
                # token row of already-counted docs (ids are ascending)
                start = np.searchsorted(ids, done_docs, side="left")
                ids, mat = ids[start:], mat[start:]
                if len(ids) == 0:
                    continue
            if leftover is not None and len(ids) and ids[0] == leftover_id:
                mat = np.concatenate([leftover, mat], axis=0)
                ids = np.concatenate(
                    [np.full(len(leftover), leftover_id, np.int32), ids])
            elif leftover is not None:
                pending_docs.append(leftover)
                leftover = None
            docs = _split_by_doc(mat, ids)
            if docs:
                leftover, leftover_id = docs[-1], ids[-1]
                pending_docs.extend(docs[:-1])
            pending_docs = emit_tiles(pending_docs)
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                if prev_event is not None:
                    prev_event.synchronize()
                prev_event = event
            if checkpoint_every and (b + 1) % checkpoint_every == 0 \
                    and engine.docs_seen > done_docs:
                # docs still pending/leftover are simply re-read on
                # resume; state_arrays gathers over the mesh, so every
                # rank calls it and rank 0 writes
                if writer:
                    _save_stream_ckpt(ckpt_path, engine, fingerprint)
                else:
                    engine.state_arrays()
        if leftover is not None:
            pending_docs.append(leftover)
        emit_tiles(pending_docs, final=True)

    with timer.stage("finalize"):
        scores, idx = engine.finalize()      # a collective on a mesh
        n_docs = engine.docs_seen
        assert k <= n_docs, f"k={k} exceeds base doc count {n_docs}"
        if writer:
            write_matrix_to_parquet(
                naming.get_partial_indices_filename(data_dir, -1), idx)
            write_matrix_to_parquet(
                naming.get_partial_distances_filename(data_dir, -1),
                -scores)
            if checkpoint_every and os.path.exists(ckpt_path):
                # consume the checkpoint on success: a stale one would
                # make a rerun over regenerated embeddings resume as
                # "complete"
                os.remove(ckpt_path)
    return timer, len(q_docs), n_docs


def print_dataset_info(source_dataset_name, token_count, actual_row_cnt,
                       actual_sentence_cnt, actual_token_embedding_counter,
                       detected_zero_embedding_cnt):
    """(reference: colbert_knn.py:129-143)"""
    print("=================================================")
    print(f"== '{source_dataset_name}' source dataset stats")
    print("== ----------------------------------------------")
    print(f"== Expected total count of source data tokens: {token_count}")
    print(f"== Total count of source data rows: {actual_row_cnt}")
    print(f"== Total count of sentences: {actual_sentence_cnt}")
    print(f"== Total count of token-embeddings: {actual_token_embedding_counter}")
    print(f"== Total count of detected zero sentence-embeddings: {detected_zero_embedding_cnt}")
    print("=================================================")
