"""The port's mel front end on tensors and its device-mel input pipeline
against the JAX package's, on the CPU: the STFT against both JAX methods,
the log-mels and their gradient, ``DeviceMelCollate`` (speaker items too),
the loader with ``device_mel`` and ``shard``, ``item_lengths``, and the
trainer taking device mels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import CMUDICT, TINY_SET, write_corpus
from gradtts_tpu.data import dataset as jds
from gradtts_tpu.data import mel as jmel
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.data import dataset as tds
from gradtts_tpu_torch.data import mel as tmel
from gradtts_tpu_torch.train.loop import train, use_device_mel

SMALL = dict(n_fft=64, hop_size=16, win_size=64)
ANALYSES = [dict(), SMALL]
IDS = ['n_fft1024', 'n_fft64']


def _audio(seed, shape=(2, 6000)):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


@pytest.mark.parametrize('kw', ANALYSES, ids=IDS)
@pytest.mark.parametrize('method', ['dft', 'fft'])
def test_stft_magnitude_matches_both_jax_methods(kw, method):
    y = _audio(0)
    n_fft, hop = kw.get('n_fft', 1024), kw.get('hop_size', 256)
    want = np.asarray(jmel.stft_magnitude(jnp.asarray(y), n_fft, hop,
                                          kw.get('win_size', 1024),
                                          method=method))
    got = tmel.stft_magnitude(torch.from_numpy(y), n_fft, hop,
                              kw.get('win_size', 1024)).numpy()
    assert got.shape == want.shape == (2, 1 + (6000 - n_fft) // hop,
                                       1 + n_fft // 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize('kw', ANALYSES, ids=IDS)
def test_mel_spectrogram_matches_jax(kw):
    y = _audio(1)
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(y), **kw))
    got = tmel.mel_spectrogram(torch.from_numpy(y), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # a waveform without a batch axis
    one = tmel.mel_spectrogram(torch.from_numpy(y[0]), **kw).numpy()
    np.testing.assert_array_equal(one, got[0].numpy())


@pytest.mark.parametrize('wire', ['float32', 'int16'])
def test_mel_from_padded_matches_jax(wire):
    rng = np.random.default_rng(2)
    audio = rng.integers(-20000, 20000, (3, 9000)).astype(np.int16)
    y = audio if wire == 'int16' else (audio / 32768.0).astype(np.float32)
    lengths = np.array([30, 12, 27], np.int32)
    want = np.asarray(jmel.mel_from_padded(jnp.asarray(y),
                                           jnp.asarray(lengths)))
    got = tmel.mel_from_padded(torch.from_numpy(y),
                               torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (3, 32, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for b, n in enumerate(lengths):
        assert (got[b, n:] == 0).all() and (got[b, :n] != 0).all()
    # numpy lengths are taken as they are
    np.testing.assert_array_equal(
        tmel.mel_from_padded(torch.from_numpy(y), lengths).numpy(), got)


@pytest.mark.parametrize('kw', ANALYSES, ids=IDS)
def test_mel_l1_gradient_matches_jax(kw):
    y = _audio(3, (2, 4096))
    target = np.array(jmel.mel_spectrogram(
        jnp.asarray(_audio(4, (2, 4096))), **kw))

    def jax_loss(wav):
        return jnp.mean(jnp.abs(jmel.mel_spectrogram(wav, **kw) - target))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(y)))
    wav = torch.from_numpy(y).requires_grad_(True)
    torch.mean(torch.abs(tmel.mel_spectrogram(wav, **kw)
                         - torch.from_numpy(target))).backward()
    got = wav.grad.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_filterbank_product_ignores_tf32_flag():
    y = torch.from_numpy(_audio(5))
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = tmel.mel_spectrogram(y)
        torch.backends.cuda.matmul.allow_tf32 = False
        off = tmel.mel_spectrogram(y)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(on, off)


# ---- the device-mel pipeline --------------------------------------------------


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp('mel_corpus'), n_items=8,
                        speakers=[7, 3, 5, 1, 0, 2, 6, 4])


def _datasets(kind, corpus, tmp_path):
    """The port's and the JAX package's dataset of ``kind`` on ``corpus``."""
    if kind == 'text':
        return (tds.TextMelDataset(corpus, CMUDICT, shuffle=False),
                jds.TextMelDataset(corpus, CMUDICT, shuffle=False))
    if kind == 'speaker_ids':
        return (tds.TextMelSpeakerDataset(corpus, CMUDICT, shuffle=False),
                jds.TextMelSpeakerDataset(corpus, CMUDICT, shuffle=False))
    spk = tmp_path / 'spk.npy'
    np.save(spk, np.random.default_rng(6).standard_normal((8, 12)).astype(
        np.float32))
    return (tds.TextMelZeroSpeakerDataset(corpus, str(spk), CMUDICT),
            jds.TextMelZeroSpeakerDataset(corpus, str(spk), CMUDICT))


@pytest.mark.parametrize('wire', ['float32', 'int16'])
@pytest.mark.parametrize('kind', ['text', 'speaker_ids', 'speaker_vectors'])
def test_device_mel_collate_matches_jax(kind, wire, corpus, tmp_path):
    port_ds, jax_ds = _datasets(kind, corpus, tmp_path)
    items = [port_ds.audio_item(i) for i in (0, 3, 5, 6)]
    j_items = [jax_ds.audio_item(i) for i in (0, 3, 5, 6)]
    for a, b in zip(items, j_items):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = tds.DeviceMelCollate.for_dataset(
        port_ds, tds.BatchCollate((32, 64), (32, 64)), 'cpu',
        upload_dtype=wire)(items)
    want = jds.DeviceMelCollate.for_dataset(
        jax_ds, jds.BatchCollate((32, 64), (32, 64)),
        upload_dtype=wire)(j_items)
    assert set(got) == set(want)
    assert isinstance(got['y'], torch.Tensor) and got['y'].device.type == 'cpu'
    assert got['y'].shape == want['y'].shape == (4, 64, 80)
    np.testing.assert_allclose(got['y'].numpy(), np.asarray(want['y']),
                               rtol=0, atol=1e-4)
    for k in set(got) - {'y'}:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], want[k])


def test_device_mel_collate_refuses_undersized_shapes(corpus):
    ds = tds.TextMelDataset(corpus, CMUDICT, shuffle=False)
    collate = tds.DeviceMelCollate.for_dataset(ds, tds.BatchCollate(), 'cpu')
    with pytest.raises(ValueError, match='smaller than local'):
        collate([ds.audio_item(0)], shapes=(4, 4))
    with pytest.raises(ValueError, match='float32 or int16'):
        tds.DeviceMelCollate(tds.BatchCollate(), 'cpu', upload_dtype='f16')


def _loader(ds, **kw):
    return tds.DataLoader(ds, 4, tds.BatchCollate((64,), (64,)),
                          shuffle=False, num_workers=1, **kw)


def test_device_mel_loader_matches_host_loader(corpus):
    ds = tds.TextMelDataset(corpus, CMUDICT, shuffle=False)
    host = list(_loader(ds))
    dev = list(_loader(ds, device_mel=True, device='cpu'))
    assert len(host) == len(dev) == 2
    for h, d in zip(host, dev):
        assert h['y'].shape == tuple(d['y'].shape)
        for k in ('x', 'x_lengths', 'y_lengths'):
            np.testing.assert_array_equal(h[k], d[k])
        # the JAX package's limit between its host and device mels
        np.testing.assert_allclose(d['y'].numpy(), h['y'], rtol=2e-3,
                                   atol=2e-3)
        for i, n in enumerate(d['y_lengths']):
            assert (d['y'][i, n:] == 0).all()
    with pytest.raises(ValueError, match='needs the device'):
        _loader(ds, device_mel=True)


def test_int16_wire_is_exact_for_pcm16(corpus):
    ds = tds.TextMelDataset(corpus, CMUDICT, shuffle=False)
    f32 = list(_loader(ds, device_mel=True, device='cpu'))
    i16 = list(_loader(ds, device_mel=True, device='cpu',
                       mel_upload_dtype='int16'))
    for a, b in zip(f32, i16):
        assert torch.equal(a['y'], b['y'])


def test_item_lengths_match_jax_and_the_decoded_shapes(corpus):
    port = tds.TextMelDataset(corpus, CMUDICT, shuffle=False)
    ref = jds.TextMelDataset(corpus, CMUDICT, shuffle=False)
    for i in range(len(port)):
        lengths = port.item_lengths(i)
        item = port[i]
        assert lengths == ref.item_lengths(i)
        assert lengths == (item['x'].shape[-1], item['y'].shape[0])


@pytest.mark.parametrize('device_mel', [False, True], ids=['host', 'device'])
def test_sharded_loader_matches_jax(device_mel, corpus):
    def batches(mod, host, **kw):
        ds = mod.TextMelDataset(corpus, CMUDICT, shuffle=False)
        collate = mod.BatchCollate((16, 24, 32, 48, 64), (32, 48, 64))
        return list(mod.DataLoader(ds, 4, collate, shuffle=True, seed=3,
                                   num_workers=2, shard=(host, 2),
                                   device_mel=device_mel, **kw))

    port = [batches(tds, h, device='cpu') for h in (0, 1)]
    ref = [batches(jds, h) for h in (0, 1)]
    for host in (0, 1):
        assert len(port[host]) == len(ref[host]) == 2
        for got, want in zip(port[host], ref[host]):
            for k in ('x', 'x_lengths', 'y_lengths'):
                np.testing.assert_array_equal(got[k], want[k])
            assert tuple(got['y'].shape) == np.shape(want['y'])
    # both hosts collate the global batch's shapes
    for a, b in zip(*port):
        assert a['x'].shape == b['x'].shape
        assert tuple(a['y'].shape) == tuple(b['y'].shape)
        assert not np.array_equal(a['x'], b['x'])


def test_device_mel_auto_rule():
    def cfg(value):
        return get_config('ljspeech', **{'train.device_mel': value})
    assert use_device_mel(cfg(None), 'cuda')
    assert not use_device_mel(cfg(None), 'cpu')
    assert use_device_mel(cfg(True), 'cpu')
    assert not use_device_mel(cfg(False), 'cuda')


def test_device_mels_train_like_host_mels(tmp_path):
    """One step from the same seed on host and device mels of the same
    corpus: the same losses within the mels' own difference."""
    overrides = {k: v for k, v in (s.split('=') for s in TINY_SET)}
    overrides = {k: int(v) for k, v in overrides.items()}
    filelist = write_corpus(tmp_path, 4)
    losses = {}
    for device_mel in (False, True):
        cfg = get_config('ljspeech', **overrides, **{
            'data.train_filelist_path': filelist,
            'data.cmudict_path': CMUDICT, 'data.x_buckets': (64,),
            'data.y_buckets': (64,), 'train.batch_size': 2,
            'train.use_bf16_compute': False,
            'train.device_mel': device_mel})
        train(cfg, max_steps=1, log_dir=str(tmp_path / str(device_mel)),
              device='cpu', synthesis_every_epoch=False)
        log = (tmp_path / str(device_mel) / 'train.log').read_text()
        losses[device_mel] = [float(kv.split('=')[1]) for kv in
                              log.split(': ')[1].split(' (')[0].split(', ')]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-3)
