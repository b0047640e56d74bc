"""PyTorch port of the `ck` slice vs the JAX reference on the CPU: the
doc-tracked token parquet, the streamed MaxSim pipeline with its
checkpoints, the doc-id maps and the MaxSim validator, the tokenizer, the
synthetic source, the BERT/ColBERT encoder on weights carried across, and
the port's `ck` entry point end to end.

Tolerances: artifact bytes identical; pipeline ids tie-tolerant against the
float64 oracle and distances within 1e-4 (fp32 sums of a few token maxima,
as tests/test_maxsim.py uses); encoder outputs within 1e-5 abs in fp32
(same weights, sums in another order) and within 2e-2 abs under bf16
activations with tanh GELU (bf16 keeps 8 mantissa bits and the two
frameworks round intermediate products at different places; outputs are
unit-norm 128-d vectors)."""

import glob
import importlib.util
import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
import jax
import jax.numpy as jnp

import neighborhoodwatch_tpu.core.colbert_pipeline as jcp
import neighborhoodwatch_tpu.core.pipeline as jpipe
import neighborhoodwatch_tpu.io.export as jexport
import neighborhoodwatch_tpu.validate as jval
from neighborhoodwatch_tpu.data import sources as jsources
from neighborhoodwatch_tpu.io.parquet_io import ParquetStreamer as JStreamer
from neighborhoodwatch_tpu.models import bert_flax, colbert_flax
from neighborhoodwatch_tpu.models import registry as jreg
from neighborhoodwatch_tpu.models import tokenizer as jtok
from neighborhoodwatch_tpu.ops import maxsim as jm
from neighborhoodwatch_tpu.utils import naming as jnaming

import neighborhoodwatch_tpu_torch.core.colbert_pipeline as tcp
import neighborhoodwatch_tpu_torch.core.pipeline as tpipe
import neighborhoodwatch_tpu_torch.io.export as texport
import neighborhoodwatch_tpu_torch.validate as tval
from neighborhoodwatch_tpu_torch.cli import ck_main
from neighborhoodwatch_tpu_torch.data import sources as tsources
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.io.parquet_io import (
    ParquetStreamer, cleanup_partial_parquet,
)
from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import colbert as tcolbert
from neighborhoodwatch_tpu_torch.models import registry as treg
from neighborhoodwatch_tpu_torch.models import tokenizer as ttok
from neighborhoodwatch_tpu_torch.ops import maxsim as tm
from neighborhoodwatch_tpu_torch.utils import naming

from tests.torch_port_util import (
    assert_ids_tie_tolerant, maxsim_oracle_wide,
)

HAVE_H5PY = importlib.util.find_spec("h5py") is not None
DIM = 16
COLS = [f"token_embedding_{i}" for i in range(DIM)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _docs(rng, n, lo, hi, dim=DIM):
    return [rng.standard_normal((int(rng.integers(lo, hi)), dim))
            .astype(np.float32) for _ in range(n)]


def _write_docs(streamer_cls, filename, docs, chunks=2):
    toks = np.concatenate(docs, axis=0)
    ids = np.concatenate([np.full(len(t), i, np.int32)
                          for i, t in enumerate(docs)])
    step = -(-len(toks) // chunks)
    with streamer_cls(filename, COLS) as st:
        for s in range(0, len(toks), step):
            st.stream_tokens_with_doc_ids(toks[s:s + step], ids[s:s + step])


def _dataset(root, q_docs, b_docs, chunks=2):
    os.makedirs(f"{root}/partial", exist_ok=True)
    qf, bf = f"{root}/q_src.parquet", f"{root}/b_src.parquet"
    _write_docs(ParquetStreamer, qf, q_docs, 1)
    _write_docs(ParquetStreamer, bf, b_docs, chunks)
    return qf, bf


def _finals(data_dir):
    idx = pq.read_table(naming.get_partial_indices_filename(
        data_dir, -1)).to_pandas().values
    dist = pq.read_table(naming.get_partial_distances_filename(
        data_dir, -1)).to_pandas().values
    return idx, dist


# ---------------------------------------------------------------- files

def test_token_parquet_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(1)
    docs = _docs(rng, 9, 2, 7)
    _write_docs(JStreamer, f"{tmp_path}/j.parquet", docs, 3)
    _write_docs(ParquetStreamer, f"{tmp_path}/t.parquet", docs, 3)
    assert _bytes(f"{tmp_path}/j.parquet") == _bytes(f"{tmp_path}/t.parquet")
    table = pq.read_table(f"{tmp_path}/t.parquet")
    assert table.schema.names[0] == "doc_id"
    assert str(table.schema.field("doc_id").type) == "int32"
    toks = np.concatenate(docs)
    for cls, name in ((JStreamer, "jf"), (ParquetStreamer, "tf")):
        with cls(f"{tmp_path}/{name}.parquet", COLS) as st:
            st.stream_to_parquet_without_src_metadata(toks[:20])
            st.stream_to_parquet_without_src_metadata(toks[20:])
    assert _bytes(f"{tmp_path}/jf.parquet") == _bytes(f"{tmp_path}/tf.parquet")
    with pytest.raises(AssertionError):
        with ParquetStreamer(f"{tmp_path}/bad.parquet", COLS[:3]) as st:
            st.stream_to_parquet_without_src_metadata(toks)
    assert not os.path.exists(f"{tmp_path}/bad.parquet")


def test_names_and_partial_cleanup_match_jax(tmp_path):
    args = ("/x/data", "colbert/v2.0", 128, 600, 120)
    assert naming.get_doc_id_map_filenames(*args) == \
        jnaming.get_doc_id_map_filenames(*args)
    assert (naming.BASE_CONFIG, naming.BASE_DATASET, naming.QUERY_DATASET) \
        == (jnaming.BASE_CONFIG, jnaming.BASE_DATASET, jnaming.QUERY_DATASET)
    part = tmp_path / "partial"
    part.mkdir()
    for name in ("distances0.parquet", "indices3.parquet",
                 "final_indices.parquet", "stream_state.npz", "keep.txt"):
        (part / name).write_text("x")
    cleanup_partial_parquet(str(part))
    assert sorted(os.listdir(part)) == ["keep.txt", "stream_state.npz"]
    cleanup_partial_parquet(str(tmp_path / "absent"))


def test_registry_matches_jax():
    assert [m.value for m in treg.EmbeddingModelName] == \
        [m.value for m in jreg.EmbeddingModelName]
    for name in treg.get_valid_model_name_list():
        assert treg.get_default_model_dimension_size(name) == \
            jreg.get_default_model_dimension_size(name)
        for dim in (None, 256, 1024):
            assert treg.get_effective_embedding_size(name, dim) == \
                jreg.get_effective_embedding_size(name, dim)
    for flags in ((True, True), (False, True), (False, False)):
        assert treg.colbert_weight_status(*flags) == \
            jreg.colbert_weight_status(*flags)
    assert not treg.is_valid_model_name("nope")


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("case", ["short", "long"])
def test_compute_maxsim_knn_matches_jax(tmp_path, case):
    """The same doc-tracked parquet through both pipelines (docs continuing
    across record batches; "long": passages past 32 tokens)."""
    rng = np.random.default_rng(5)
    k = 4 if case == "short" else 3
    q_docs = _docs(rng, 5, 2, 6)
    b_docs = _docs(rng, 23, 2, 9) if case == "short" \
        else _docs(rng, 14, 20, 70)
    out = {}
    for name, mod in (("jax", jcp), ("torch", tcp)):
        root = str(tmp_path / name)
        qf, bf = _dataset(root, q_docs, b_docs)
        kw = {} if name == "jax" else {"device": "cpu"}
        _, n_q, n_b = mod.compute_maxsim_knn(root, qf, bf, k=k, tile_docs=8,
                                             batch_rows=40, **kw)
        assert (n_q, n_b) == (len(q_docs), len(b_docs))
        out[name] = _finals(root)
        assert not os.path.exists(f"{root}/partial/stream_state.npz")
    q, qm = jm.pad_token_lists(q_docs, DIM)
    d, dm = jm.pad_token_lists(b_docs, DIM)
    os_, oi, ow = maxsim_oracle_wide(q, qm, d, dm, k)
    assert_ids_tie_tolerant(out["torch"][0], out["jax"][0], ow, 1e-4)
    assert_ids_tie_tolerant(out["torch"][0], oi, ow, 1e-4)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-4)
    np.testing.assert_allclose(out["torch"][1], -os_, atol=1e-4)
    assert (np.diff(out["torch"][1], axis=1) >= -1e-6).all()


def test_compute_maxsim_knn_rejects_untracked_base_and_mesh(tmp_path):
    rng = np.random.default_rng(6)
    root = str(tmp_path)
    qf, bf = _dataset(root, _docs(rng, 3, 2, 5), _docs(rng, 9, 2, 5))
    flat = f"{root}/flat.parquet"
    with ParquetStreamer(flat, COLS) as st:
        st.stream_to_parquet_without_src_metadata(
            rng.standard_normal((30, DIM)).astype(np.float32))
    with pytest.raises(AssertionError, match="doc_id"):
        tcp.compute_maxsim_knn(root, qf, flat, k=2, device="cpu")
    # a value that is no mesh is refused
    with pytest.raises(TypeError, match="Mesh from make_mesh"):
        tcp.compute_maxsim_knn(root, qf, bf, k=2, mesh=object(),
                               device="cpu")
    with pytest.raises(TypeError, match="Mesh from make_mesh"):
        tcp.process_knn_computation(root, bf, 10, qf, 5, mesh=object(),
                                    device="cpu")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_maxsim_checkpoint_resumes_across_packages(tmp_path, capsys, writer,
                                                   reader):
    """A checkpoint at 12/23 base docs written by one package's
    accumulator and checkpoint writer is resumed by the other package's
    pipeline (row groups under the checkpoint skipped), and the finished
    stream equals the oracle."""
    rng = np.random.default_rng(8)
    k, done = 4, 12
    q_docs, b_docs = _docs(rng, 5, 2, 6), _docs(rng, 23, 2, 9)
    root = str(tmp_path)
    qf, bf = _dataset(root, q_docs, b_docs, chunks=3)
    assert pq.ParquetFile(bf).metadata.num_row_groups >= 3
    q, qm = jm.pad_token_lists(q_docs, DIM)
    d_head, dm_head = jm.pad_token_lists(b_docs[:done], DIM)
    if writer == "jax":
        eng, save = jm.StreamingMaxSim(q, qm, k=k), jpipe._save_stream_ckpt
    else:
        eng = tm.StreamingMaxSim(q, qm, k=k, device="cpu")
        save = tpipe._save_stream_ckpt
    eng.update(d_head, dm_head)
    st, stq = os.stat(bf), os.stat(qf)
    fingerprint = {"f_mode": "maxsim", "f_k": k, "f_base": bf,
                   "f_q": len(q_docs), "f_dims": DIM,
                   "f_qpad": eng.state[0].shape[0], "f_prec": "highest",
                   "f_bsize": st.st_size, "f_bmtime": round(st.st_mtime, 3),
                   "f_qsize": stq.st_size,
                   "f_qmtime": round(stq.st_mtime, 3)}
    save(tpipe._stream_ckpt_path(root), eng, fingerprint)
    assert tpipe._stream_ckpt_path(root) == jpipe._stream_ckpt_path(root)
    capsys.readouterr()
    if reader == "jax":
        _, n_q, n_b = jcp.compute_maxsim_knn(root, qf, bf, k=k, tile_docs=8,
                                             batch_rows=40)
    else:
        _, n_q, n_b = tcp.compute_maxsim_knn(root, qf, bf, k=k, tile_docs=8,
                                             batch_rows=40, device="cpu")
    assert "resuming MaxSim stream from checkpoint: 12" in \
        capsys.readouterr().out
    assert (n_q, n_b) == (5, 23)
    idx, dist = _finals(root)
    d, dm = jm.pad_token_lists(b_docs, DIM)
    os_, oi, ow = maxsim_oracle_wide(q, qm, d, dm, k)
    assert_ids_tie_tolerant(idx, oi, ow, 1e-4)
    np.testing.assert_allclose(dist, -os_, atol=1e-4)


# ------------------------------------------- doc maps and the validator

def _artifact_set(root, mod_export, q_docs, b_docs, k, hdf5):
    """fvec/ivec artifact set of a finished maxsim run, written by one
    package's exporters from the float64 oracle's results."""
    os.makedirs(f"{root}/partial", exist_ok=True)
    qf, bf = f"{root}/q_src.parquet", f"{root}/b_src.parquet"
    _write_docs(ParquetStreamer, qf, q_docs, 1)
    _write_docs(ParquetStreamer, bf, b_docs, 2)
    q, qm = jm.pad_token_lists(q_docs, DIM)
    d, dm = jm.pad_token_lists(b_docs, DIM)
    scores, idx = jm.maxsim_oracle(q, qm, d, dm, k)
    from neighborhoodwatch_tpu_torch.io.parquet_io import (
        write_matrix_to_parquet,
    )
    write_matrix_to_parquet(naming.get_partial_indices_filename(root, -1),
                            idx.astype(np.int32))
    write_matrix_to_parquet(naming.get_partial_distances_filename(root, -1),
                            (-scores).astype(np.float32))
    n_q = sum(len(t) for t in q_docs)
    n_b = sum(len(t) for t in b_docs)
    files = mod_export.generate_output_files(
        root, "colbertv2.0", DIM, bf, qf, n_b, n_q,
        naming.get_partial_indices_filename(root, -1),
        naming.get_partial_distances_filename(root, -1), k, hdf5, COLS)
    docs = mod_export.export_maxsim_doc_maps(
        root, "colbertv2.0", DIM, qf, bf, n_b, n_q, k, hdf5)
    maps = naming.get_doc_id_map_filenames(root, "colbertv2.0", DIM, n_b,
                                           n_q)
    return files, maps, docs, (n_q, n_b)


def test_doc_maps_match_jax_and_jax_validator_accepts_them(tmp_path):
    rng = np.random.default_rng(9)
    q_docs, b_docs, k = _docs(rng, 6, 2, 5), _docs(rng, 20, 2, 6), 3
    sets = {name: _artifact_set(str(tmp_path / name), mod, q_docs, b_docs,
                                k, HAVE_H5PY)
            for name, mod in (("jax", jexport), ("torch", texport))}
    assert sets["torch"][2] == sets["jax"][2] == (6, 20)
    for tf, jf in zip(sets["torch"][0] + sets["torch"][1],
                      sets["jax"][0] + sets["jax"][1]):
        assert os.path.basename(tf) == os.path.basename(jf)
        assert _bytes(tf) == _bytes(jf), os.path.basename(tf)
    if HAVE_H5PY:
        import h5py
        n_q, n_b = sets["torch"][3]
        h5 = {name: glob.glob(f"{tmp_path}/{name}/*.hdf5")[0]
              for name in sets}
        with h5py.File(h5["torch"]) as ft, h5py.File(h5["jax"]) as fj:
            assert sorted(ft) == sorted(fj)
            assert ft.attrs["maxsim"] == fj.attrs["maxsim"] == 1
            for g in ft:
                np.testing.assert_array_equal(ft[g][...], fj[g][...])
                assert dict(ft[g].attrs) == dict(fj[g].attrs)
            assert ft["train_doc_ids"].shape == (n_b, 1)
    # each side's validator accepts the other's files
    root = str(tmp_path / "torch")
    files, maps = sets["torch"][0], sets["torch"][1]
    assert jval.validate_maxsim_files(root, files[0], files[1], *maps,
                                      files[2], files[3]) == 0
    root = str(tmp_path / "jax")
    files, maps = sets["jax"][0], sets["jax"][1]
    assert tval.validate_maxsim_files(root, files[0], files[1], *maps,
                                      files[2], files[3]) == 0


@pytest.mark.parametrize("corruption", ["pristine", "distance", "neighbour",
                                        "sampled", "map_gap"])
def test_maxsim_validator_catches_corruption(tmp_path, corruption):
    """The corruptions of tests/test_maxsim.py, judged equally by both
    validators."""
    rng = np.random.default_rng(7)
    dim, k = 8, 3
    q_docs = _docs(rng, 6, 2, 5, dim)
    b_docs = _docs(rng, 20, 2, 6, dim)
    scores = np.array([[(q.astype(np.float64) @ b.astype(np.float64).T)
                        .max(axis=1).sum() for b in b_docs] for q in q_docs])
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k].astype(np.int32)
    dist = -np.take_along_axis(scores, idx.astype(np.int64), axis=1)
    bmap = np.concatenate([np.full(len(t), i, np.int32)
                           for i, t in enumerate(b_docs)])
    kw = {}
    if corruption == "distance":
        dist[2, -1] += 0.25          # last column: rows stay monotone
    elif corruption == "neighbour":
        # a wrong neighbour with its true score: only the exhaustive
        # optimality check can catch it
        worst = int(np.argsort(-scores[0])[-1])
        idx[0, 0] = worst
        dist[0, 0] = -scores[0, worst]
        order = np.argsort(dist[0], kind="stable")
        idx[0], dist[0] = idx[0][order], dist[0][order]
    elif corruption == "sampled":
        kw = dict(exhaustive=False, sample=4)
    elif corruption == "map_gap":
        bmap[bmap == 7] = 8
    d = str(tmp_path)
    names = dict(query_vector_fvec="q.fvec", base_vector_fvec="b.fvec",
                 query_doc_map_ivec="qmap.ivec",
                 base_doc_map_ivec="bmap.ivec",
                 indices_ivec="n.ivec", distances_fvec="dist.fvec")
    fvec.write_vectors(f"{d}/q.fvec", np.concatenate(q_docs), "f")
    fvec.write_vectors(f"{d}/b.fvec", np.concatenate(b_docs), "f")
    fvec.write_vectors(f"{d}/qmap.ivec", np.concatenate(
        [np.full(len(t), i, np.int32)
         for i, t in enumerate(q_docs)])[:, None], "i")
    fvec.write_vectors(f"{d}/bmap.ivec", bmap[:, None], "i")
    fvec.write_vectors(f"{d}/n.ivec", idx, "i")
    fvec.write_vectors(f"{d}/dist.fvec", dist.astype(np.float32), "f")
    if corruption == "map_gap":
        for val in (tval, jval):
            with pytest.raises(AssertionError, match="gaps"):
                val.validate_maxsim_files(d, **names)
        return
    got = tval.validate_maxsim_files(d, **names, **kw)
    want = jval.validate_maxsim_files(d, **names, **kw)
    assert got == want
    assert (got == 0) == (corruption in ("pristine", "sampled"))


# ---------------------------------------------- tokenizer and sources

def test_hash_tokenizer_and_sources_match_jax():
    texts = ["Sentence about w12 w4999 w7.", "a",
             "Dr. Smith went to the U.S. in 1999! Then? He left... " * 9,
             "punctuation, (lots) of: it; \"quoted\" & more " * 3]
    jt, tt = jtok.HashTokenizer(), ttok.HashTokenizer()
    for max_length in (16, 64, 220):
        for marker in (None, 2):
            ji, jmask = jt(texts, max_length=max_length,
                           insert_after_cls=marker)
            ti, tmask = tt(texts, max_length=max_length,
                           insert_after_cls=marker)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tmask, jmask)
            assert ti.shape[1] in (16, 32, 64, 128, 220)
    assert tt.is_hashed and ttok.load_tokenizer("no/such-model",
                                                quiet=True).is_hashed
    for t in texts + ["One. Two! Three? e.g. this stays. J. K. Rowling "
                      "wrote it.\n\nNew paragraph here"]:
        assert tsources.split_into_sentences(t) == \
            jsources.split_into_sentences(t)
    assert tsources.split_into_sentences({"text": "Alpha beta. Gamma "
                                          "delta."}) == \
        ["Alpha beta.", "Gamma delta."]
    for kind, rows in (("query", 7), ("document", 12)):
        a = tsources.synthetic_dataset(kind, rows)
        b = jsources.synthetic_dataset(kind, rows)
        assert a.rows == b.rows and a.column_names == b.column_names
        assert len(a) == rows
    assert tsources.load_query_source(3).rows == \
        jsources.load_query_source(3).rows
    assert tsources.load_base_source(3).rows == \
        jsources.load_base_source(3).rows
    assert len(a.filter(lambda r: r["id"] == "0")) == 1
    assert not tsources._valid_parquet("/no/such/file.parquet")


# ---------------------------------------------------------------- encoder

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128)


def _flax_colbert(dtype, seed=3):
    cfg = bert_flax.BertConfig(dtype=dtype, **SMALL)
    model = colbert_flax.ColbertModel(cfg)
    dummy = jnp.zeros((1, 16), dtype=jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), dummy, jnp.ones_like(dummy))
    # flax zero-inits biases and unit-inits layernorms: perturb them so a
    # mis-mapped bias or scale cannot pass unnoticed
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
        .astype(np.float32), params)
    return cfg, model, params


def _ids(seed, batch=3, seq=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(999, 30522, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, 20:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_colbert_model_matches_flax_on_carried_weights(dtype, atol):
    jcfg, jmodel, params = _flax_colbert(dtype)
    tcfg = tbert.BertConfig(dtype=dtype, **SMALL)
    assert tbert._gelu_approximate(tcfg) == \
        bool(bert_flax._gelu_approximate(jcfg)) == (dtype == "bfloat16")
    tmodel = tcolbert.ColbertModel(tcfg)
    tmodel.load_state_dict(tcolbert.colbert_state_from_flax(params, tcfg))
    tmodel.eval()
    ids, mask = _ids(4)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids),
                                   jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, 32, 128)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=atol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[valid], axis=-1), 1.0,
                               atol=1e-5)
    # the backbone alone
    jh = np.asarray(bert_flax.BertEncoder(jcfg).apply(
        {"params": params["params"]["bert"]}, jnp.asarray(ids),
        jnp.asarray(mask)))
    with torch.no_grad():
        th = tmodel.bert(torch.from_numpy(ids).long(),
                         torch.from_numpy(mask)).numpy()
    assert th.dtype == np.float32
    np.testing.assert_allclose(th[valid], jh[valid],
                               atol=atol * (1 if dtype == "float32" else 10),
                               rtol=0)


def test_hf_state_dict_conversion_agrees_with_the_flax_route():
    """HF BERT names -> the port's state_dict gives the same module as the
    JAX package's convert_torch_state_dict followed by the flax route."""
    cfg = tbert.BertConfig(dtype="float32", **SMALL)
    ref = tcolbert.ColbertModel(cfg)
    tbert.init_params(ref, seed=5)
    again = tcolbert.ColbertModel(cfg)
    tbert.init_params(again, seed=5)
    for a, b in zip(ref.parameters(), again.parameters()):
        assert torch.equal(a, b)                  # seeded init repeats
    hf = {"linear.weight": ref.linear.weight.detach().numpy()}
    names = {"attention.query": "attention.self.query",
             "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention.out": "attention.output.dense",
             "attention_ln": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense", "output": "output.dense",
             "output_ln": "output.LayerNorm"}
    for key, val in ref.bert.state_dict().items():
        val = val.numpy()
        if key.startswith("layers."):
            _, i, rest = key.split(".", 2)
            mod, part = rest.rsplit(".", 1)
            hf[f"bert.encoder.layer.{i}.{names[mod]}.{part}"] = val
        elif key.startswith("embeddings_ln"):
            hf["bert.embeddings.LayerNorm." + key.split(".")[1]] = val
        else:
            hf["bert.embeddings." + key] = val
    direct = tcolbert.colbert_state_from_torch(hf, cfg)
    jcfg = bert_flax.BertConfig(dtype="float32", **SMALL)
    flax_params = jax.tree.map(
        np.asarray, colbert_flax.colbert_params_from_state_dict(hf, jcfg))
    via_flax = tcolbert.colbert_state_from_flax(flax_params, cfg)
    want = ref.state_dict()
    assert set(direct) == set(via_flax) == set(want)
    for key in want:
        np.testing.assert_array_equal(direct[key].numpy(), want[key].numpy())
        np.testing.assert_array_equal(via_flax[key].numpy(),
                                      want[key].numpy())


def test_encode_passages_matches_jax_generator():
    """Token counts, order and embeddings of encode_passages on carried
    weights; the window of in-flight batches drains in order."""
    jcfg, _, params = _flax_colbert("float32", seed=6)
    tcfg = tbert.BertConfig(dtype="float32", **SMALL)
    jgen = colbert_flax.ColbertFlaxEmbeddingGenerator(
        params=jax.tree.map(jnp.asarray, params), config=jcfg)
    tgen = tcolbert.ColbertEmbeddingGenerator(
        state=tcolbert.colbert_state_from_flax(params, tcfg), config=tcfg,
        device="cpu")
    assert tgen.tokenizer.is_hashed and not tgen.use_doc_marker
    assert tgen.dimensions == jgen.dimensions == 128
    texts = [f"Sentence number {i} about " + " ".join(
        f"w{j}" for j in range(i % 9 + 1)) + "." for i in range(11)]
    je, jc = jgen.encode_passages(texts, batch_size=3, max_in_flight=2)
    te, tc = tgen.encode_passages(texts, batch_size=3, max_in_flight=2)
    assert tc == jc and te.shape == je.shape == (sum(jc), 128)
    np.testing.assert_allclose(te, je, atol=1e-5, rtol=0)
    assert tgen.tokens_seen == jgen.tokens_seen == sum(jc)
    flat, counts = tgen.generate_embedding(texts[0])
    assert len(flat) == 1 and flat[0].shape == (counts[0] * 128,)
    assert tgen.encode_passages([])[1] == []
    with pytest.raises(NotImplementedError):
        tgen._call_model_api(["x"])
    # the source loop: same passages, doc ids and counts on both sides
    rows = tsources.synthetic_dataset("document", 6)

    class Sink:
        def __init__(self):
            self.calls = []

        def stream_tokens_with_doc_ids(self, toks, ids):
            self.calls.append((toks, ids))

    sinks = {}
    for name, mod, gen in (("jax", jcp, jgen), ("torch", tcp, tgen)):
        sinks[name] = Sink()
        stats = mod.process_source_dataset(sinks[name], gen, rows, 128, 70,
                                           "text", track_docs=True)
        assert stats[2] == 70
        sinks[name].stats = stats
    assert sinks["torch"].stats == sinks["jax"].stats
    (tt_, ti_), = sinks["torch"].calls
    (jt_, ji_), = sinks["jax"].calls
    np.testing.assert_array_equal(ti_, ji_)
    np.testing.assert_allclose(tt_, jt_, atol=1e-5, rtol=0)


# ------------------------------------------------------------ entry point

def test_ck_maxsim_end_to_end(tmp_path, capsys):
    """The port's `ck --maxsim` on the CPU at the token counts the JAX
    package's own ck test uses, BERT-base width, seeded random weights:
    its own validator and the JAX package's both find 0 mismatches."""
    qt, bt, k = 120, 600, 5
    ck_main([str(qt), str(bt), "-k", str(k), "--synthetic", "-es", "small",
             "--maxsim", "--post-validation", "--yes", "--device", "cpu",
             "--data-dir", str(tmp_path)]
            + ([] if HAVE_H5PY else ["--no-gen-hdf5"]))
    out = capsys.readouterr().out
    assert "Total mismatch count: 0" in out
    assert "RANDOM INIT" in out and "encoder pipeline:" in out
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), "colbertv2.0_maxsim_synthetic", qt, bt, k)
    files = naming.get_ivec_fvec_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt, k)
    maps = naming.get_doc_id_map_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt)
    assert jval.validate_maxsim_files(data_dir, files[0], files[1], *maps,
                                      files[2], files[3]) == 0
    neigh = fvec.read_vectors(files[2])
    dist = fvec.read_vectors(files[3])
    q_ids = fvec.read_vectors(maps[0])[:, 0]
    b_ids = fvec.read_vectors(maps[1])[:, 0]
    assert len(q_ids) == qt and len(b_ids) == bt
    assert neigh.shape == dist.shape == (int(q_ids.max()) + 1, k)
    assert neigh.min() >= 0 and neigh.max() <= int(b_ids.max())
    assert np.all(np.diff(dist, axis=1) >= -1e-5)
    assert glob.glob(f"{data_dir}/colbert_knn_*.log")
    if HAVE_H5PY:
        import h5py
        with h5py.File(glob.glob(f"{data_dir}/*.hdf5")[0]) as f:
            assert f.attrs["maxsim"] == 1
            assert f["test_doc_ids"].shape == (qt, 1)
    # a second run resumes from the token parquets
    ck_main([str(qt), str(bt), "-k", str(k), "--synthetic", "-es", "small",
             "--maxsim", "--device", "cpu", "--no-gen-hdf5",
             "--data-dir", str(tmp_path)])
    assert "already exists, skipping" in capsys.readouterr().out


def test_ck_flat_token_end_to_end(tmp_path, capsys):
    """The flat token mode through the first slice's streamed kNN + merge,
    as tests/test_cli_e2e.py runs the JAX `ck`."""
    qt, bt, k = 150, 800, 8
    ck_main([str(qt), str(bt), "-k", str(k), "--synthetic", "-es", "small",
             "--post-validation", "-y", "--device", "cpu",
             "--data-dir", str(tmp_path)]
            + ([] if HAVE_H5PY else ["--no-gen-hdf5"]))
    assert "Total mismatch count: 0" in capsys.readouterr().out
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), "colbertv2.0_synthetic", qt, bt, k)
    files = naming.get_ivec_fvec_filenames(data_dir, "colbertv2.0", 128, bt,
                                           qt, k)
    assert fvec.read_vectors(files[0]).shape == (qt, 128)
    assert fvec.read_vectors(files[1]).shape == (bt, 128)
    idx = fvec.read_vectors(files[2])
    assert idx.shape == (qt, k) and idx.min() >= 0 and idx.max() < bt
    assert jval.validate_files_v0(data_dir, *files, metric="dot") == 0


def test_ck_refuses_mesh_bad_scale_and_missing_card(tmp_path, capsys):
    base = ["40", "80", "-k", "2", "--synthetic", "--data-dir",
            str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        ck_main(base + ["--mesh", "2", "--device", "cpu"])
    assert e.value.code == 2
    # 2 ranks asked for, a world of 1 without a launcher
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ck_main(base + ["-es", "huge", "--device", "cpu"])
    with pytest.raises(AssertionError, match="reserved for the ColBERT"):
        ck_main(base + ["-m", "intfloat/e5-small-v2", "--device", "cpu"])
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck_main(base)
