"""The port's data pipeline (``gradtts_tpu_torch.data``) against the JAX
package's on a synthetic corpus: the numpy mel front end, the WAV readers,
bucketed collation and the loader's batches for one seed. Both sides are
numpy code, so every array is compared exactly."""

import numpy as np
import pytest

from _torch_port import CMUDICT, write_corpus
from gradtts_tpu.data import dataset as jds
from gradtts_tpu.data import mel as jmel
from gradtts_tpu_torch.data import dataset as tds
from gradtts_tpu_torch.data import mel as tmel


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp('corpus'), n_items=7)


def test_mel_front_end_matches(corpus):
    path = tds.parse_filelist(corpus)[3][0]
    audio, sr = tds.load_wav(path)
    j_audio, j_sr = jds.load_wav(path)
    assert sr == j_sr == 22050
    np.testing.assert_array_equal(audio, j_audio)
    assert tds.wav_header(path) == jds.wav_header(path)
    np.testing.assert_array_equal(tmel.mel_filterbank(22050, 1024),
                                  jmel.mel_filterbank(22050, 1024))
    got = tmel.mel_spectrogram_np(audio[None])
    want = jmel.mel_spectrogram_np(audio[None])
    assert got.shape == want.shape and got.shape[-1] == 80
    np.testing.assert_array_equal(got, want)


def test_dataset_items_match(corpus):
    port = tds.TextMelDataset(corpus, CMUDICT, seed=3)
    ref = jds.TextMelDataset(corpus, CMUDICT, seed=3)
    assert len(port) == len(ref) == 7
    for i in range(len(port)):
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got['x'], want['x'])
        np.testing.assert_array_equal(got['y'], want['y'])


def test_collate_buckets_match():
    rng = np.random.default_rng(0)
    # the last item is longer than the largest y bucket: it keeps its length
    items = [{'x': rng.integers(1, 50, n).astype(np.int32),
              'y': rng.standard_normal((f, 80)).astype(np.float32)}
             for n, f in ((9, 30), (40, 61), (12, 140))]
    port = tds.BatchCollate((16, 64), (32, 64, 128))(items)
    ref = jds.BatchCollate((16, 64), (32, 64, 128))(items)
    assert port['y'].shape == (3, 140, 80)
    assert set(port) == set(ref)
    for k in port:
        np.testing.assert_array_equal(port[k], ref[k])


def test_loader_batches_match(corpus):
    def batches(mod):
        ds = mod.TextMelDataset(corpus, CMUDICT, seed=5)
        loader = mod.DataLoader(ds, 2, mod.BatchCollate((64,), (64,)),
                                shuffle=True, seed=11, num_workers=2)
        return [list(loader) for _ in range(2)]          # two epochs

    port, ref = batches(tds), batches(jds)
    assert [len(e) for e in port] == [3, 3]              # drop_last
    for port_epoch, ref_epoch in zip(port, ref):
        for got, want in zip(port_epoch, ref_epoch):
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    # each epoch shuffles anew
    assert not all(np.array_equal(a['x'], b['x'])
                   for a, b in zip(port[0], port[1]))
