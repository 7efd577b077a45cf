"""The port's data pipeline against the reference, on the CPU: the
synthetic streams give the same arrays, and the BitWeaving document
filter (two ``bitweaving_scan`` calls, the kernel's plain version here)
selects the same documents, at document counts that are not a multiple
of 32 too."""

import numpy as np
import pytest

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_synthetic_lm_batches_equal(shards):
    cfg = dict(vocab=97, seq_len=12, global_batch=8, seed=5)
    a = ref.SyntheticLM(ref.DataConfig(**cfg))
    b = port.SyntheticLM(port.DataConfig(**cfg))
    for step in (0, 1, 7, 1000):
        for shard in range(shards):
            want = a.batch_at(step, shard, shards)
            got = b.batch_at(step, shard, shards)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (step, shard, k)


@pytest.mark.parametrize("n", [1, 31, 4096, 5003])
def test_corpus_meta_equal(n):
    want, got = ref.synth_corpus_meta(n, seed=3), port.synth_corpus_meta(
        n, seed=3)
    for field in ("quality", "length", "lang"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n", [33, 1000, 4096, 5003])
@pytest.mark.parametrize("pred", [(64, 250, 256), (0, 255, 0), (7, 7, 4095),
                                  (200, 100, 10)])
def test_filter_documents_equal(n, use_kernel, pred):
    meta = ref.synth_corpus_meta(n, seed=n)
    want = ref.filter_documents(meta, *pred, use_kernel=use_kernel)
    got = port.filter_documents(port.synth_corpus_meta(n, seed=n), *pred,
                                use_kernel=use_kernel, device="cpu")
    q, ln = meta.quality, meta.length
    numpy = (q >= pred[0]) & (q <= pred[1]) & (ln >= pred[2])
    assert got.dtype == np.bool_ and got.shape == (n,)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, numpy)


@pytest.mark.parametrize("n_docs", [100, 4096])
def test_filtered_stream_equal(n_docs):
    cfg = dict(vocab=50, seq_len=6, global_batch=4, seed=2)
    a = ref.FilteredSyntheticLM(ref.DataConfig(**cfg), n_docs=n_docs)
    b = port.FilteredSyntheticLM(port.DataConfig(**cfg), n_docs=n_docs,
                                 device="cpu")
    assert np.array_equal(b.mask, np.asarray(a.mask))
    assert np.array_equal(b.doc_ids, a.doc_ids)
    for step in (0, 3, 11):
        want, got = a.batch_at(step, 1, 2), b.batch_at(step, 1, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (step, k)


def test_filter_selecting_nothing_raises():
    with pytest.raises(ValueError, match="zero documents"):
        port.FilteredSyntheticLM(port.DataConfig(10, 4, 2), n_docs=64,
                                 q_min=250, q_max=10, device="cpu")
