"""PyTorch port of the `nw` slice vs the JAX reference on the CPU: the e5
encoder (configs, pooling, the generator with its deferred readback), the
HTTP generators, the registry, the sentence-embedding pipeline with its
two-phase base selection and resume-by-artifact, `device_trace`, the
packaging of the kernel sources, and the port's `nw` entry point end to
end.

Weights are carried across from the Flax modules (`bert_state_from_flax`).
The encoder cases use a small BERT (2 layers, hidden 64); the generator and
dataset cases use e5-small-v2's width cut to 2 layers, so that the
embeddings have the registry's 384 dimensions.

Tolerances: metadata, row order, token counts, request payloads and
decisions (skips, failures, dispatch) identical; fp32 encoder outputs
within 1e-5 abs (same weights, sums in another order); bf16 activations
with tanh GELU within 2e-2 abs on the unit-norm embeddings (the bf16
tolerance tests/test_torch_port_colbert.py uses for the same BERT module:
bf16 keeps 8 mantissa bits and the two frameworks round at different
places)."""

import dataclasses
import glob
import http.server
import importlib
import importlib.util
import json
import os
import threading
import tomllib

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
import jax
import jax.numpy as jnp

import neighborhoodwatch_tpu.validate as jval
from neighborhoodwatch_tpu.data import sources as jsources
from neighborhoodwatch_tpu.io.parquet_io import ParquetStreamer as JStreamer
from neighborhoodwatch_tpu.models import bert_flax, e5_flax
from neighborhoodwatch_tpu.models import generators as jgen
from neighborhoodwatch_tpu.models import registry as jreg

from neighborhoodwatch_tpu_torch.cli import nw_main
from neighborhoodwatch_tpu_torch.data import sources as tsources
from neighborhoodwatch_tpu_torch.io import fvec
from neighborhoodwatch_tpu_torch.io.parquet_io import ParquetStreamer
from neighborhoodwatch_tpu_torch.models import bert as tbert
from neighborhoodwatch_tpu_torch.models import e5 as te5
from neighborhoodwatch_tpu_torch.models import generators as tgen
from neighborhoodwatch_tpu_torch.models import registry as treg
from neighborhoodwatch_tpu_torch.utils import naming
from neighborhoodwatch_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAVE_H5PY = importlib.util.find_spec("h5py") is not None
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128)
E5_SMALL = "intfloat/e5-small-v2"


def _flax_params(cfg, seed):
    """Flax BertEncoder params as numpy, biases and layernorms perturbed so
    a mis-mapped bias or scale cannot pass unnoticed."""
    params = bert_flax.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
        .astype(np.float32), params)


def _ids(seed, batch=4, seq=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(999, 30522, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, 20:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


# ---------------------------------------------------------------- encoder

def test_e5_configs_match_flax():
    assert set(tbert.E5_CONFIGS) == set(bert_flax.E5_CONFIGS)
    for name, jc in bert_flax.E5_CONFIGS.items():
        tc = tbert.E5_CONFIGS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
    large = tbert.E5_CONFIGS["intfloat/e5-large-v2"]
    assert (large.hidden_size, large.num_layers, large.num_heads,
            large.intermediate_size, large.dtype) == \
        (1024, 24, 16, 4096, "bfloat16")


def test_mean_pool_normalize_matches_flax():
    """Masked mean in fp32 with the count clamped at 1 (an all-masked row)
    and a zero norm left as 1 (an all-zero row)."""
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((5, 9, 24)).astype(np.float32)
    mask = (rng.random((5, 9)) < 0.6).astype(np.int32)
    mask[:, 0] = 1
    mask[3] = 0                      # no valid token
    hidden[4] = 0.0                  # zero pooled vector
    want = np.asarray(bert_flax.mean_pool_normalize(jnp.asarray(hidden),
                                                    jnp.asarray(mask)))
    got = tbert.mean_pool_normalize(torch.from_numpy(hidden),
                                    torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[3:], 0.0)
    np.testing.assert_allclose(np.linalg.norm(got[:3], axis=1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_e5_encoder_matches_flax_on_carried_weights(dtype, atol):
    """BertEncoder + mean_pool_normalize, the e5 embedding, on weights
    carried from the Flax module, at both activation dtypes."""
    jcfg = bert_flax.BertConfig(dtype=dtype, **SMALL)
    tcfg = tbert.BertConfig(dtype=dtype, **SMALL)
    params = _flax_params(jcfg, seed=11)
    model = tbert.BertEncoder(tcfg)
    model.load_state_dict(tbert.bert_state_from_flax(params["params"], tcfg))
    model.eval()
    ids, mask = _ids(12)
    jh = bert_flax.BertEncoder(jcfg).apply(params, jnp.asarray(ids),
                                           jnp.asarray(mask))
    want = np.asarray(bert_flax.mean_pool_normalize(jh, jnp.asarray(mask)))
    with torch.no_grad():
        th = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        got = tbert.mean_pool_normalize(th, torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_attention_impl_flash_raises_and_xla_is_auto():
    """"flash" (the fused masked attention, ported as
    csrc/masked_attention.cu) runs: on CPU tensors at a sequence of 32,
    outside its gate, it is the written-out attention; an unknown value
    raises; "xla" is the written-out attention "auto" selects."""
    with pytest.raises(ValueError, match="attention_impl"):
        tbert.BertEncoder(tbert.BertConfig(attention_impl="sdpa", **SMALL))
    ids, mask = _ids(13)
    outs = []
    for impl in ("auto", "xla", "flash"):
        model = tbert.BertEncoder(tbert.BertConfig(
            dtype="float32", attention_impl=impl, **SMALL))
        tbert.init_params(model, seed=3)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask)))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])


# -------------------------------------------------------------- generator

@pytest.fixture()
def e5_two_layers(monkeypatch):
    """e5-small-v2 at its width (384 hidden, 12 heads, FFN 1536) cut to 2
    layers in fp32, in both packages' config tables; returns the Flax
    params (numpy) and the port's state_dict carrying them."""
    jcfg = dataclasses.replace(bert_flax.E5_CONFIGS[E5_SMALL], num_layers=2,
                               dtype="float32")
    tcfg = dataclasses.replace(tbert.E5_CONFIGS[E5_SMALL], num_layers=2,
                               dtype="float32")
    monkeypatch.setitem(bert_flax.E5_CONFIGS, E5_SMALL, jcfg)
    monkeypatch.setitem(tbert.E5_CONFIGS, E5_SMALL, tcfg)
    params = _flax_params(jcfg, seed=21)
    return params, tbert.bert_state_from_flax(params["params"], tcfg)


def _generators(params, state, max_length=64):
    j = e5_flax.E5FlaxEmbeddingGenerator(
        E5_SMALL, max_length=max_length,
        params=jax.tree.map(jnp.asarray, params))
    t = te5.E5EmbeddingGenerator(E5_SMALL, max_length=max_length,
                                 state=state, device="cpu")
    return j, t


def _poison(gen, marker="POISON", exc=RuntimeError):
    """Make the generator's tokenizer raise on any chunk holding `marker`."""
    tok = gen.tokenizer

    def tokenize(texts, *a, **kw):
        if any(marker in t for t in texts):
            raise exc("planted chunk failure")
        return tok(texts, *a, **kw)
    gen.tokenizer = tokenize


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [f"Sentence {i} about " + " ".join(
        f"w{int(x)}" for x in rng.integers(0, 900, size=1 + i % 23)) + "."
        for i in range(n)]


def test_e5_generator_matches_flax_on_carried_weights(e5_two_layers,
                                                      monkeypatch):
    """Two full chunks and a ragged 6-row tail, tokens counted alike, the
    "query:" prefix once; ONE device-to-host copy per call."""
    params, state = e5_two_layers
    jg, tg = _generators(params, state)
    assert tg.pretrained and jg.pretrained
    assert tg.chunk_size == jg.chunk_size == 64
    assert tg.dimensions == jg.dimensions == 384
    texts = _texts(134)
    want = np.asarray(jg.generate_embedding(texts))
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", counting_cpu)
        got = tg.generate_embedding(texts)
    assert copies == [(134, 384)]
    got = np.asarray(got)
    assert got.shape == want.shape == (134, 384) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tg.tokens_seen == jg.tokens_seen > 0
    one = tg.generate_embedding(texts[5])
    np.testing.assert_allclose(one[0], got[5], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg._call_model_api(["query:" + texts[7]])[0],
                               got[7], atol=1e-5, rtol=0)


def test_e5_generator_failed_chunk_gives_zeros_for_that_chunk_only(
        e5_two_layers):
    params, state = e5_two_layers
    jg, tg = _generators(params, state)
    texts = _texts(150, seed=1)
    texts[70] = "POISON sentence."            # the second of three chunks
    for g in (jg, tg):
        _poison(g)
    want = np.asarray(jg.generate_embedding(texts))
    got = np.asarray(tg.generate_embedding(texts))
    zero = ~np.any(got != 0, axis=1)
    np.testing.assert_array_equal(zero, ~np.any(want != 0, axis=1))
    np.testing.assert_array_equal(np.nonzero(zero)[0], np.arange(64, 128))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # every chunk failing: all zeros, no copy of an empty list
    assert not np.any(tg.generate_embedding(["POISON"] * 3))
    # a contract violation is a caller bug: it passes through
    for g in (jg, tg):
        _poison(g, marker="ASSERT", exc=AssertionError)
        with pytest.raises(AssertionError):
            g.generate_embedding(["fine", "ASSERT here"])


def test_e5_generator_seeded_random_init(e5_two_layers):
    """No checkpoint: a seeded random init, the same weights for the same
    seed, `pretrained` False."""
    a = te5.E5EmbeddingGenerator(E5_SMALL, max_length=32, device="cpu")
    b = te5.E5EmbeddingGenerator(E5_SMALL, max_length=32, device="cpu")
    c = te5.E5EmbeddingGenerator(E5_SMALL, max_length=32, seed=1,
                                 device="cpu")
    assert not a.pretrained
    x = np.asarray(a.generate_embedding(["alpha beta", "gamma"]))
    np.testing.assert_array_equal(x, np.asarray(
        b.generate_embedding(["alpha beta", "gamma"])))
    assert np.abs(x - np.asarray(
        c.generate_embedding(["alpha beta", "gamma"]))).max() > 1e-3
    with pytest.raises(AssertionError, match="not an e5 model"):
        te5.E5EmbeddingGenerator("colbertv2.0", device="cpu")


# -------------------------------------------------------- HTTP generators

def _transport(dim, record, key="data"):
    def transport(url, payload, headers):
        record.append((url, json.loads(json.dumps(payload)), dict(headers)))
        texts = payload.get("input") or payload.get("texts") or \
            [i["content"] for i in payload["instances"]]
        vecs = [[float(len(t) + j) / 100 for j in range(dim)] for t in texts]
        if key == "predictions":
            return {"predictions": [{"embeddings": {"values": v}}
                                    for v in vecs]}
        if key == "embeddings":
            return {"embeddings": vecs}
        return {"data": [{"embedding": v} for v in vecs]}
    return transport


HTTP_CASES = {
    "openai-v3": ("OpenAIEmbeddingGenerator",
                  dict(model_name="text-embedding-3-small",
                       output_dimension_size=256), 256, "data", {}),
    "openai-ada": ("OpenAIEmbeddingGenerator",
                   dict(model_name="text-embedding-ada-002"), 1536, "data",
                   {}),
    "vertex": ("VertexAIEmbeddingGenerator",
               dict(model_name="text-embedding-004"), 768, "predictions", {}),
    "nemo": ("NvidiaNemoEmbeddingGenerator", {}, 1024, "data", {}),
    "cohere": ("CohereEmbeddingV3Generator",
               dict(model_name="cohere/embed-english-light-3.0"), 384,
               "embeddings", {"input_type": "search_document"}),
    "voyage": ("VoyageAIEmbeddingGenerator",
               dict(model_name="voyage-3-large", input_type="query",
                    output_dtype="int8", output_dimension_size=512), 512,
               "data", {}),
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_generator_matches_jax_on_a_mock_transport(case):
    """Each remote generator: the same URLs, request payloads and headers
    as the JAX package's, chunked at 64, and the same outputs."""
    cls, kwargs, dim, key, call_kw = HTTP_CASES[case]
    texts = [f"text number {i}" for i in range(70)]
    outs, records = {}, {}
    for name, mod in (("jax", jgen), ("torch", tgen)):
        records[name] = []
        g = getattr(mod, cls)(transport=_transport(dim, records[name], key),
                              **kwargs)
        assert g.dimensions == dim and g.chunk_size == 64
        outs[name] = np.asarray(g.generate_embedding(texts, **call_kw),
                                dtype=np.float64)
    assert records["torch"] == records["jax"]
    assert len(records["torch"]) == 2            # 64 + 6
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert outs["torch"].shape == (70, dim)


def test_http_generator_contracts_match_jax(monkeypatch):
    """Cohere's required input_type, Voyage's dtype and dimension rules,
    the API-key requirement without a transport, and the zero fallback of
    a failing request."""
    rec = []
    for mod in (jgen, tgen):
        g = mod.CohereEmbeddingV3Generator(transport=_transport(1024, rec))
        with pytest.raises(ValueError, match="input_type"):
            g.generate_embedding(["x"])
        with pytest.raises(AssertionError):
            g._call_model_api(["x"])
        for bad in (dict(output_dimension_size=300),
                    dict(output_dtype="float16")):
            with pytest.raises(AssertionError):
                mod.VoyageAIEmbeddingGenerator(
                    transport=_transport(512, rec), **bad)
        with pytest.raises(AssertionError):
            mod.VoyageAIEmbeddingGenerator(
                "voyage-3-lite", output_dtype="int8",
                transport=_transport(512, rec))
        lite = mod.VoyageAIEmbeddingGenerator(
            "voyage-3-lite", input_type=None, output_dtype=None,
            transport=_transport(512, rec))
        assert (lite.input_type, lite.output_dtype, lite.dimensions) == \
            ("document", "float", 512)
        for var, make in (("OPENAI_API_KEY", mod.OpenAIEmbeddingGenerator),
                          ("COHERE_API_KEY", mod.CohereEmbeddingV3Generator),
                          ("VOYAGE_API_KEY", mod.VoyageAIEmbeddingGenerator)):
            monkeypatch.delenv(var, raising=False)
            with pytest.raises(RuntimeError, match=var):
                make()

        def broken(url, payload, headers):
            raise OSError("service down")
        g = mod.NvidiaNemoEmbeddingGenerator(transport=broken)
        out = g.generate_embedding(["a", "b"])
        assert len(out) == 2 and not np.any(out)


class _Handler(http.server.BaseHTTPRequestHandler):
    seen = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.seen.append((self.path, body, self.headers["Authorization"],
                          self.headers["Content-Type"]))
        if body.get("model") == "fail":
            self.send_response(500)
            self.end_headers()
            return
        reply = json.dumps({"data": [{"embedding": [1.0, float(i)]}
                                     for i in range(len(body["input"]))]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(reply.encode())

    def log_message(self, *args):
        pass


def test_default_transport_posts_json_over_http():
    """The stdlib transport against a server on this host: a JSON POST
    with the given headers, the JSON reply decoded, an HTTP error status
    raised."""
    server = http.server.HTTPServer(("127.0.0.1", 0), _Handler)
    worker = threading.Thread(target=server.serve_forever, daemon=True)
    worker.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/embeddings"
    try:
        got = tgen._default_transport(url, {"input": ["a", "b"], "model": "m"},
                                      {"Authorization": "Bearer k"},
                                      timeout=10)
        assert got == {"data": [{"embedding": [1.0, 0.0]},
                                {"embedding": [1.0, 1.0]}]}
        assert _Handler.seen[-1] == ("/v1/embeddings",
                                     {"input": ["a", "b"], "model": "m"},
                                     "Bearer k", "application/json")
        with pytest.raises(Exception, match="500"):
            tgen._default_transport(url, {"input": ["a"], "model": "fail"},
                                    {}, timeout=10)
        bearer = tgen._bearer_transport("tok")
        bearer(url, {"input": ["c"], "model": "m"}, {})
        assert _Handler.seen[-1][2] == "Bearer tok"
    finally:
        server.shutdown()
        server.server_close()
        worker.join(timeout=10)
    assert not worker.is_alive()


# --------------------------------------------------------------- registry

def test_registry_dispatch_and_weight_status_match_jax(monkeypatch,
                                                       e5_two_layers):
    for var in ("OPENAI_API_KEY", "COHERE_API_KEY", "VOYAGE_API_KEY",
                "GOOGLE_ACCESS_TOKEN"):
        monkeypatch.setenv(var, "test-key")
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "test-project")
    for name in treg.get_valid_model_name_list():
        assert treg.local_weight_status(name) == \
            jreg.local_weight_status(name), name
        if name == "colbertv2.0":
            continue                      # built below, on the CPU
        kw = dict(output_dimension=256) if name == "text-embedding-3-large" \
            else dict(dataset_type="query") if name.startswith("voyage") \
            else {}
        if "e5" in name and name != E5_SMALL:
            continue                      # full-width inits: one is enough
        t = treg.get_embedding_generator_for_model(name, device="cpu", **kw)
        j = jreg.get_embedding_generator_for_model(name, **kw)
        want = type(j).__name__.replace("Flax", "")
        assert type(t).__name__ == want, name
        assert t.dimensions == j.dimensions and t.model_name == name
        if "e5" in name:
            assert t.device.type == "cpu" and not t.pretrained
    colbert = treg.get_embedding_generator_for_model("colbertv2.0",
                                                     device="cpu")
    assert type(colbert).__name__ == "ColbertEmbeddingGenerator"
    assert colbert.device.type == "cpu"
    assert "RANDOM INIT" in treg.local_weight_status(E5_SMALL)
    assert treg.local_weight_status("voyage-3-lite") == \
        "remote API (weights server-side)"
    monkeypatch.delenv("VOYAGE_API_KEY")
    with pytest.raises(RuntimeError, match="VOYAGE_API_KEY"):
        treg.get_embedding_generator_for_model("voyage-3-lite",
                                               dataset_type="query")


# ---------------------------------------------------------------- sources

def _read(path):
    table = pq.read_table(path)
    emb = [c for c in table.column_names if c.startswith("embedding_")]
    meta = table.drop_columns(emb).to_pylist()
    return meta, table.select(emb).to_pandas().values


def _assert_same_parquet(got, want, atol=1e-5):
    gm, ge = _read(got)
    wm, we = _read(want)
    assert pq.read_schema(got) == pq.read_schema(want)
    assert gm == wm
    np.testing.assert_allclose(ge, we, atol=atol, rtol=0)


def test_process_dataset_matches_jax(tmp_path, e5_two_layers, capsys):
    """The same rows, sentences, metadata (titles with "_" -> " ") and
    order; a failed chunk's zero embeddings skipped alike; the section's
    tokens/s reported."""
    params, state = e5_two_layers
    gens = _generators(params, state)
    rows = [dict(r) for r in tsources.synthetic_dataset("query", 200)]
    for i, r in enumerate(rows):
        r["title"] = r["title"].replace(" ", "_")
        if i % 7 == 0:
            r["question"] += " Second sentence here! And a third?"
    # the first 64-sentence chunk of the first 100-sentence batch fails
    rows[10]["question"] = "POISON in the first chunk."
    results = {}
    for (name, mod, streamer), g in zip(
            (("jax", jsources, JStreamer), ("torch", tsources,
                                            ParquetStreamer)), gens):
        _poison(g)
        ds = mod._ListDataset(rows, ["id", "title", "question"])
        path = str(tmp_path / f"{name}.parquet")
        with streamer(path, ds.column_names) as st:
            results[name] = mod.process_dataset(
                "query", st, ds, 100, "question", E5_SMALL, generator=g)
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == 100 and results["torch"][1] == 64
    _assert_same_parquet(str(tmp_path / "torch.parquet"),
                         str(tmp_path / "jax.parquet"))
    meta, _ = _read(str(tmp_path / "torch.parquet"))
    assert all("_" not in m["title"] for m in meta)
    assert "embedding pipeline:" in capsys.readouterr().out
    assert tsources.SENTENCE_BATCH_SIZE == jsources.SENTENCE_BATCH_SIZE


def test_get_embeddings_from_map_keeps_grouping():
    class Gen(tgen.EmbeddingGenerator):
        def _call_model_api(self, text_list, *a, **kw):
            self.kw = kw
            return [np.full(384, len(t), np.float32) for t in text_list]
    g = Gen(E5_SMALL, chunk_size=2)
    out = tsources.get_embeddings_from_map([(3, ["ab", "cde"]), (5, ["f"])], g)
    assert [k for k, _ in out] == [3, 5]
    assert [v[0] for _, vs in out for v in vs] == [8, 9, 7]  # "query:" + t

    class Cohere(tgen.CohereEmbeddingV3Generator):
        def _call_model_api(self, text_list, *a, **kw):
            self.kw = kw
            return [np.ones(1024, np.float32)] * len(text_list)
    c = Cohere(transport=lambda *a: None)
    tsources.get_batch_embeddings_from_generator(["x"], c, "query")
    assert c.kw == {"input_type": "search_query"}
    tsources.get_batch_embeddings_from_generator(["x"], c, "document")
    assert c.kw == {"input_type": "search_document"}


def _hf_dataset(n, seed):
    datasets = pytest.importorskip("datasets")
    src = jsources.synthetic_dataset("document", n, seed=seed)
    rows = [dict(r, title=r["title"].replace(" ", "_")) for r in src]
    return datasets.Dataset.from_list(rows)


def test_split_by_title_matches_jax_for_hf_views_and_lists():
    """Arrow `is_in` over an HF dataset (and over a select() view, whose
    backing table holds other rows), `.filter` over a _ListDataset: the
    same rows in the same order as the JAX package."""
    hf = _hf_dataset(60, seed=4)
    view = hf.select(list(range(59, -1, -2)))
    titles = {"Topic 1", "Topic 4", "Topic 7", "Topic 10"}
    listed = tsources.synthetic_dataset("document", 60, seed=4)
    for ds in (hf, view, listed):
        got = tsources._split_dataset_by_title(ds, titles)
        want = jsources._split_dataset_by_title(ds, titles)
        for g, w in zip(got, want):
            assert list(g) == list(w)
        assert len(got[0]) + len(got[1]) == len(ds)
        assert len(got[0]) > 0 and all(
            r["title"].replace("_", " ") in titles for r in got[0])


@pytest.mark.parametrize("source", ["list", "hf"])
def test_generate_query_and_base_datasets_match_jax(tmp_path, e5_two_layers,
                                                    source):
    """Query set, then the two-phase base set (titles in the query set
    first, then the rest) in both packages: identical metadata and row
    order, embeddings within 1e-5; a second call resumes by artifact; an
    unreadable file at the final path is regenerated."""
    params, state = e5_two_layers
    gens = dict(zip(("jax", "torch"), _generators(params, state)))
    qsrc = tsources.synthetic_dataset("query", 40)
    bsrc = tsources.synthetic_dataset("document", 150) if source == "list" \
        else _hf_dataset(150, seed=0)
    files = {}
    for name, mod in (("jax", jsources), ("torch", tsources)):
        d = str(tmp_path / name)
        os.makedirs(d)
        qf = mod.generate_query_dataset(d, E5_SMALL, 25, 384, source=qsrc,
                                        generator=gens[name])
        bf = mod.generate_base_dataset(d, E5_SMALL, qf, 60, 384,
                                       source=bsrc, generator=gens[name])
        files[name] = (qf, bf)
    for j, t in zip(files["jax"], files["torch"]):
        assert os.path.basename(j) == os.path.basename(t)
        _assert_same_parquet(t, j)
    qtitles = {m["title"] for m in _read(files["torch"][0])[0]}
    btitles = [m["title"] for m in _read(files["torch"][1])[0]]
    n_in = sum(t in qtitles for t in btitles)
    assert n_in > 0 and all(t in qtitles for t in btitles[:n_in])
    assert not any(t in qtitles for t in btitles[n_in:])
    # resume by artifact: no source, no generator, nothing regenerated
    d = str(tmp_path / "torch")
    mtime = os.path.getmtime(files["torch"][1])
    assert tsources.generate_query_dataset(d, E5_SMALL, 25, 384) == \
        files["torch"][0]
    assert tsources.generate_base_dataset(
        d, E5_SMALL, files["torch"][0], 60, 384) == files["torch"][1]
    assert os.path.getmtime(files["torch"][1]) == mtime
    with open(files["torch"][1], "wb") as f:
        f.write(b"not a parquet")
    tsources.generate_base_dataset(d, E5_SMALL, files["torch"][0], 60, 384,
                                   source=bsrc, generator=gens["torch"])
    _assert_same_parquet(files["torch"][1], files["jax"][1])


def test_undersized_source_publishes_nothing(tmp_path, e5_two_layers):
    params, state = e5_two_layers
    _, g = _generators(params, state)
    src = tsources.synthetic_dataset("query", 10)
    with pytest.raises(AssertionError, match="Expected 25 rows"):
        tsources.generate_query_dataset(str(tmp_path), E5_SMALL, 25, 384,
                                        source=src, generator=g)
    assert not glob.glob(str(tmp_path / "*.parquet"))


# ------------------------------------------------------------ device_trace

def test_device_trace_writes_a_chrome_trace(tmp_path, capsys):
    with tprof.device_trace(str(tmp_path / "t")):
        x = torch.ones(64, 64)
        (x @ x).sum()
    (path,) = glob.glob(str(tmp_path / "t" / "device_trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert "device trace written" in capsys.readouterr().out
    with tprof.device_trace(None):
        pass
    with tprof.device_trace(""):
        pass
    assert len(os.listdir(tmp_path)) == 1


def test_device_trace_tolerates_the_profiler_only(tmp_path, monkeypatch,
                                                  capsys):
    """A profiler that fails to start or stop is reported and the region
    runs untraced; an error inside the region propagates."""
    class NoStart:
        def __init__(self, **kw):
            pass

        def start(self):
            raise RuntimeError("CUPTI unavailable")

    class NoStop(NoStart):
        def start(self):
            pass

        def stop(self):
            raise RuntimeError("stop failed")
    ran = []
    for cls, msg in ((NoStart, "continuing untraced"),
                     (NoStop, "stop/export failed")):
        with monkeypatch.context() as m:
            m.setattr(torch.profiler, "profile", cls)
            with tprof.device_trace(str(tmp_path)):
                ran.append(cls)
        assert msg in capsys.readouterr().out
    assert ran == [NoStart, NoStop]
    with pytest.raises(ZeroDivisionError):
        with tprof.device_trace(str(tmp_path / "e")):
            1 / 0
    assert glob.glob(str(tmp_path / "e" / "device_trace_*.json"))


# -------------------------------------------------------------- packaging

def test_package_data_holds_every_kernel_source():
    """An installed (non-editable) copy must carry every file the kernel
    build reads: each csrc/*.cu and the headers they include."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    globs = project["tool"]["setuptools"]["package-data"][
        "neighborhoodwatch_tpu_torch"]
    pkg = os.path.join(REPO, "neighborhoodwatch_tpu_torch")
    packaged = {os.path.relpath(p, pkg) for g in globs
                for p in glob.glob(os.path.join(pkg, g))}
    sources = glob.glob(os.path.join(pkg, "csrc", "*.cu"))
    assert sources
    for src in sources:
        assert os.path.relpath(src, pkg) in packaged
        with open(src) as f:
            for line in f:
                if line.startswith("#include \""):
                    inc = os.path.join("csrc", line.split('"')[1])
                    assert os.path.exists(os.path.join(pkg, inc)), inc
                    assert inc in packaged, f"{inc} is not packaged"
    scripts = project["project"]["scripts"]
    for name in ("nw-torch", "nw-tools-torch", "ck-torch"):
        mod, fn = scripts[name].split(":")
        assert mod.startswith("neighborhoodwatch_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), fn))


# ------------------------------------------------------------ entry point

@pytest.mark.parametrize("dataset_api", [False, True])
def test_nw_end_to_end_on_the_cpu(tmp_path, capsys, dataset_api):
    """The port's `nw` at e5-small-v2's full shape (seeded random weights,
    hash tokenizer) through both kNN paths: its artifacts pass its own
    validator and the JAX package's `validate_files`, and `--trace-dir`
    leaves a trace of the kNN stage."""
    q, b, k = 20, 200, 5
    argv = [str(q), str(b), "-k", str(k), "-m", E5_SMALL, "--synthetic",
            "--post-validation", "--yes", "--device", "cpu",
            "--data-dir", str(tmp_path), "--trace-dir",
            str(tmp_path / "trace")]
    if dataset_api:
        argv.append("--use-dataset-api")
    if not HAVE_H5PY:
        argv.append("--no-gen-hdf5")
    nw_main(argv)
    out = capsys.readouterr().out
    assert "Total mismatch count: 0" in out
    assert "RANDOM INIT" in out and "device:              cpu" in out
    assert "embedding pipeline:" in out
    data_dir = naming.get_model_data_homedir(
        str(tmp_path), E5_SMALL + "_synthetic", q, b, k)
    files = naming.get_ivec_fvec_filenames(data_dir, E5_SMALL, 384, b, q, k)
    assert fvec.read_vectors(files[0]).shape == (q, 384)
    assert fvec.read_vectors(files[1]).shape == (b, 384)
    idx = fvec.read_vectors(files[2])
    assert idx.shape == (q, k) and idx.min() >= 0 and idx.max() < b
    assert jval.validate_files(data_dir, *files, metric="sqeuclidean") == 0
    assert jval.validate_files_v0(data_dir, *files) == 0
    assert glob.glob(str(tmp_path / "trace" / "device_trace_*.json"))
    if HAVE_H5PY:
        assert os.path.exists(naming.get_hdf5_filename(
            data_dir, E5_SMALL, 384, b, q, k))
    # a second run resumes from the parquet artifacts
    nw_main(argv)
    out = capsys.readouterr().out
    assert "already exists" in out and "Total mismatch count: 0" in out


def test_nw_refuses_mesh_colbert_and_a_missing_card(tmp_path, capsys,
                                                    monkeypatch):
    base = ["10", "40", "-k", "2", "-m", E5_SMALL, "--synthetic",
            "--data-dir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        nw_main(base + ["--mesh", "2", "--device", "cpu"])
    assert e.value.code == 2
    # 2 ranks asked for, a world of 1 without a launcher
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="use the `ck` program"):
        nw_main(base[:4] + ["-m", "colbertv2.0", "--synthetic",
                            "--device", "cpu"])
    with pytest.raises(AssertionError, match="unknown embedding model"):
        nw_main(base[:4] + ["-m", "no-such-model", "--device", "cpu"])
    # the default device is the card: no silent CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nw_main(base)
    assert not os.listdir(tmp_path)
