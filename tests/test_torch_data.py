"""The port's tokenizers and data pipeline against the JAX package's, on
the CPU: merges, ids and saved files of the tokenizers, and every batch of
the pipeline, equal exactly (both are numpy and pure Python)."""

import json

import numpy as np
import pytest

from repro.data import pipeline as jpipeline
from repro.data import tokenizer as jtokenizer
from repro_torch.data import pipeline, tokenizer

TEXTS = [
    "the quick brown fox jumps over the lazy dog; the dog sleeps.",
    "pQuant: 1-bit weights, an 8-bit branch — décodé, 量子化, 🙂",
    "",
    "aaaa aaaa aaab abab abab",
]


def _corpus(n=40, seed=0):
    rng = np.random.default_rng(seed)
    words = ["quant", "bit", "branch", "the", "weight", "decouple", "token", "ffn", "αβ", "ß"]
    return [" ".join(rng.choice(words, size=12)) + "." for _ in range(n)]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_equals_jax(text):
    a, b = tokenizer.ByteTokenizer(), jtokenizer.ByteTokenizer()
    assert a.vocab_size == b.vocab_size == 259
    for bos in (True, False):
        assert a.encode(text, add_bos=bos) == b.encode(text, add_bos=bos)
    assert a.decode(a.encode(text)) == b.decode(b.encode(text)) == text


@pytest.fixture(scope="module")
def bpe():
    corpus = _corpus()
    return (tokenizer.BPETokenizer.train(corpus, vocab_size=330),
            jtokenizer.BPETokenizer.train(corpus, vocab_size=330))


def test_bpe_merges_equal_jax(bpe):
    a, b = bpe
    assert a.merges == b.merges and len(a.merges) > 20
    assert a.vocab_size == b.vocab_size


@pytest.mark.parametrize("text", TEXTS + _corpus(3, seed=1))
def test_bpe_ids_equal_jax(bpe, text):
    a, b = bpe
    ids = a.encode(text)
    assert ids == b.encode(text)
    assert a.decode(ids) == b.decode(ids) == text


def test_bpe_file_loads_in_the_other_package(bpe, tmp_path):
    a, b = bpe
    a.save(str(tmp_path / "port.json"))
    b.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    from_port = jtokenizer.BPETokenizer.load(str(tmp_path / "port.json"))
    from_jax = tokenizer.BPETokenizer.load(str(tmp_path / "jax.json"))
    assert from_port.merges == from_jax.merges == a.merges
    text = _corpus(1, seed=2)[0]
    assert from_port.encode(text) == from_jax.encode(text) == a.encode(text)


def _assert_batches_equal(a, b):
    assert set(a) == set(b) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_jax(host_index, host_count):
    kw = dict(seq_len=24, global_batch=4, host_index=host_index, host_count=host_count, seed=3)
    dc, jdc = pipeline.DataConfig(**kw), jpipeline.DataConfig(**kw)
    assert dc.host_batch == jdc.host_batch == 4 // host_count
    src, jsrc = pipeline.SyntheticSource(97, seed=5), jpipeline.SyntheticSource(97, seed=5)
    np.testing.assert_array_equal(src.trans, jsrc.trans)
    for step in (0, 1, 17):
        _assert_batches_equal(pipeline.host_batch(src, dc, step),
                              jpipeline.host_batch(jsrc, jdc, step))


def test_text_file_batches_equal_jax(tmp_path, bpe):
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(_corpus(30, seed=4)))
    dc = pipeline.DataConfig(seq_len=16, global_batch=3, seed=1)
    jdc = jpipeline.DataConfig(seq_len=16, global_batch=3, seed=1)
    for tok, jtok in ((None, None), bpe):
        src = pipeline.TextFileSource([str(path)], tokenizer=tok)
        jsrc = jpipeline.TextFileSource([str(path)], tokenizer=jtok)
        np.testing.assert_array_equal(src.buf, jsrc.buf)
        assert src.vocab == jsrc.vocab
        for step in (0, 5):
            _assert_batches_equal(pipeline.host_batch(src, dc, step),
                                  jpipeline.host_batch(jsrc, jdc, step))


def test_prefetch_iterator_equals_jax():
    dc = pipeline.DataConfig(seq_len=12, global_batch=2, seed=2, prefetch=2)
    jdc = jpipeline.DataConfig(seq_len=12, global_batch=2, seed=2, prefetch=2)
    it = pipeline.PrefetchIterator(pipeline.SyntheticSource(50, seed=1), dc, start_step=3)
    jit = jpipeline.PrefetchIterator(jpipeline.SyntheticSource(50, seed=1), jdc, start_step=3)
    try:
        for want_step in range(3, 8):
            (s, b), (js, jb) = next(it), next(jit)
            assert s == js == want_step
            _assert_batches_equal(b, jb)
    finally:
        it.close()
        jit.close()
    assert not it.thread.is_alive()  # close() joins the worker
