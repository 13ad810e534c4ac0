"""The port's dataset preparation (gradtts_tpu_torch/data/sph.py,
data/corpus.py, cli/prepare.py), held to the checks of tests/test_prepare.py
(SPHERE and the TED-LIUM STM pipeline) and tests/test_corpus.py (lhotse cut
manifests), and to the JAX package's functions on the same files: equal
samples, headers, records, wavs and filelists. ``prepare spk-emb`` is
refused (its ECAPA weights need a download)."""

import gzip
import json
import os

import numpy as np
import pytest

from gradtts_tpu.cli.prepare import main as jax_prepare_main
from gradtts_tpu.data import corpus as jcorpus
from gradtts_tpu.data import sph as jsph
from gradtts_tpu_torch.cli.prepare import main as prepare_main
from gradtts_tpu_torch.data import corpus as tcorpus
from gradtts_tpu_torch.data import sph as tsph
from gradtts_tpu_torch.data.dataset import load_wav

FS = 16000


def _write_sph(path, data, sr=FS, byte_format='01', coding='pcm'):
    """A NIST SPHERE file of int16 ``data`` (PCM in ``byte_format``) or of
    u-law bytes (``coding='ulaw'``)."""
    header_size = 1024
    n_bytes = 1 if coding == 'ulaw' else 2
    fields = (f'sample_rate -i {sr}\n'
              f'channel_count -i 1\n'
              f'sample_n_bytes -i {n_bytes}\n'
              f'sample_count -i {len(data)}\n'
              f'sample_byte_format -s{len(byte_format)} {byte_format}\n'
              f'sample_coding -s{len(coding)} {coding}\n'
              'end_head\n')
    head = f'NIST_1A\n{header_size:8d}\n{fields}'.encode('ascii')
    head = head + b' ' * (header_size - len(head))
    dtype = (np.uint8 if coding == 'ulaw' else
             '<i2' if byte_format == '01' else '>i2')
    with open(path, 'wb') as f:
        f.write(head)
        f.write(np.asarray(data, dtype).tobytes())


def _tone(seconds=1.0, f0=220.0, amp=0.5):
    t = np.arange(int(seconds * FS)) / FS
    return (amp * np.sin(2 * np.pi * f0 * t) * 32767).astype(np.int16)


# --- SPHERE ----------------------------------------------------------------


@pytest.mark.parametrize('byte_format', ['01', '10'])
def test_sph_roundtrip(tmp_path, byte_format):
    """Both byte orders read back to the written samples, as the JAX
    reader reads them, header and all."""
    wav = _tone()
    path = str(tmp_path / 'a.sph')
    _write_sph(path, wav, byte_format=byte_format)
    data, sr = tsph.read_sph(path)
    assert sr == FS and data.shape == (FS,)
    np.testing.assert_allclose(data, wav.astype(np.float32) / 32768.0,
                               atol=1e-6)
    want, want_sr = jsph.read_sph(path)
    assert sr == want_sr
    np.testing.assert_array_equal(data, want)
    assert tsph.read_sph_header(path) == jsph.read_sph_header(path)


def test_sph_ulaw_and_windows_match_jax(tmp_path):
    """u-law samples and [start, end) windows: the same floats as the JAX
    reader's; the u-law tone keeps its shape."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / 'u.sph')
    _write_sph(path, rng.integers(0, 256, FS), coding='ulaw')
    for start, end in ((None, None), (0.25, 0.5), (0.9, 2.0)):
        got, sr = tsph.read_sph(path, start, end)
        want, _ = jsph.read_sph(path, start, end)
        assert sr == FS and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() <= 1.0
    # G.711 u-law of a sine: encode by the standard's segment table
    wav = _tone(0.1).astype(np.int32)
    sign = (wav < 0).astype(np.uint8) << 7
    mag = np.minimum(np.abs(wav), 32635) + 0x84
    exp = np.floor(np.log2(mag)).astype(np.int32) - 7
    mant = (mag >> (exp + 3)) & 0x0F
    _write_sph(path, ~(sign | (exp << 4) | mant).astype(np.uint8),
               coding='ulaw')
    got, _ = tsph.read_sph(path)
    assert np.corrcoef(got, wav)[0, 1] > 0.999


def test_sph_refuses_shorten_like_jax(tmp_path):
    path = str(tmp_path / 's.sph')
    _write_sph(path, _tone(0.1), coding='pcm,embedded-shorten-v2.00')
    for reader in (tsph.read_sph, jsph.read_sph):
        with pytest.raises(ValueError, match='shorten'):
            reader(path)
    (tmp_path / 'x.sph').write_bytes(b'RIFF0000WAVE')
    with pytest.raises(ValueError, match='not a NIST SPHERE'):
        tsph.read_sph(str(tmp_path / 'x.sph'))


def test_sph_segment_to_wav(tmp_path):
    wav = (np.linspace(-0.5, 0.5, 2 * FS) * 32767).astype(np.int16)
    sph = str(tmp_path / 'b.sph')
    _write_sph(sph, wav)
    out = str(tmp_path / 'seg.wav')
    tsph.sph_segment_to_wav(sph, out, 0.5, 1.0)
    data, sr = load_wav(out)
    assert sr == FS and data.shape == (FS // 2,)
    np.testing.assert_allclose(
        data, wav[FS // 2:FS].astype(np.float32) / 32768.0, atol=2e-4)
    jsph.sph_segment_to_wav(sph, str(tmp_path / 'jseg.wav'), 0.5, 1.0)
    assert open(out, 'rb').read() == open(tmp_path / 'jseg.wav', 'rb').read()


# --- the TED-LIUM pipeline ---------------------------------------------------


def _tedlium_corpus(root):
    """Two talks of SPHERE audio and their STM transcripts (one line of
    each talk to be ignored, one speaker in two talks)."""
    sph_dir, stm_dir = root / 'sph', root / 'stm'
    sph_dir.mkdir()
    stm_dir.mkdir()
    _write_sph(str(sph_dir / 'AlGore_2009.sph'), _tone(4.0, 200.0, 0.4))
    _write_sph(str(sph_dir / 'AlGore_2010.sph'), _tone(3.0, 150.0, 0.3))
    _write_sph(str(sph_dir / 'JaneDoe_2011.sph'), _tone(3.0, 260.0, 0.3))
    (stm_dir / 'AlGore_2009.stm').write_text(
        'AlGore_2009 1 AlGore 0.50 1.50 <o,f0,male> hello there world\n'
        'AlGore_2009 1 AlGore 2.00 3.00 <o,f0,male> '
        'ignore_time_segment_in_scoring\n'
        'AlGore_2009 1 AlGore 3.00 3.80 <o,f0,male> good morning\n')
    (stm_dir / 'AlGore_2010.stm').write_text(
        'AlGore_2010 1 AlGore 0.25 1.75 <o,f0,male> it \'s (um) [noise] '
        'Back  AGAIN\n'
        'too short\n')
    (stm_dir / 'JaneDoe_2011.stm').write_text(
        'JaneDoe_2011 1 JaneDoe 1.00 2.50 <o,f0,female> a new voice\n'
        'JaneDoe_2011 1 JaneDoe 2.50 2.90 <o,f0,female> {breath}\n')
    (stm_dir / 'notes.txt').write_text('not an stm file\n')
    return sph_dir, stm_dir


def _prepare(main, root, sph_dir, stm_dir):
    wav_dir = root / 'wav'
    main(['tedlium-segment', '--sph-dir', str(sph_dir), '--stm-dir',
          str(stm_dir), '--out-dir', str(wav_dir)])
    filelist = root / 'train.txt'
    main(['tedlium-filelist', '--stm-dir', str(stm_dir), '--wav-dir',
          str(wav_dir), '--speaker-dict', str(wav_dir / 'speaker_dict.txt'),
          '--out', str(filelist), '--require-wav'])
    return wav_dir, filelist


def test_tedlium_prepare_pipeline(tmp_path, capsys):
    """segment + filelist subcommands end-to-end on a synthetic corpus, as
    tests/test_prepare.py runs the JAX CLI, with one line printed per STM
    file for each subcommand."""
    sph_dir, stm_dir = _tedlium_corpus(tmp_path)
    wav_dir, filelist = _prepare(prepare_main, tmp_path, sph_dir, stm_dir)
    wavs = sorted(f for f in os.listdir(wav_dir) if f.endswith('.wav'))
    assert len(wavs) == 5      # the ignore_time_segment line is dropped
    assert (wav_dir / 'speaker_dict.txt').read_text() == \
        '1: AlGore\n2: JaneDoe\n'
    lines = filelist.read_text().strip().splitlines()
    assert len(lines) == 4     # the {breath} line normalizes to nothing
    wav_path, text, spk = lines[0].split('|')
    assert os.path.exists(wav_path)
    assert text == 'hello there world'
    assert spk == '1'
    assert lines[2].split('|')[1:] == ["it's back again", '1']
    out = capsys.readouterr().out
    for stm in ('[1/3] AlGore_2009.stm', '[2/3] AlGore_2010.stm',
                '[3/3] JaneDoe_2011.stm'):
        assert out.count(stm) == 2
    assert 'notes.txt' not in out


def test_tedlium_prepare_matches_jax_cli(tmp_path):
    """The port's and the JAX package's CLIs on the same corpus: the same
    wav names and bytes, speaker dictionary and filelist lines."""
    sph_dir, stm_dir = _tedlium_corpus(tmp_path)
    out = {}
    for side, main in (('jax', jax_prepare_main), ('port', prepare_main)):
        (tmp_path / side).mkdir()
        out[side] = _prepare(main, tmp_path / side, sph_dir, stm_dir)
    (jwav, jlist), (twav, tlist) = out['jax'], out['port']
    assert sorted(os.listdir(twav)) == sorted(os.listdir(jwav))
    for name in os.listdir(jwav):
        assert (twav / name).read_bytes() == (jwav / name).read_bytes()
    assert tlist.read_text().replace(str(twav), 'W') == \
        jlist.read_text().replace(str(jwav), 'W')


def test_spk_emb_is_refused(tmp_path):
    """ECAPA embeddings need speechbrain's weights from the network: the
    subcommand exits with a message and writes nothing."""
    filelist = tmp_path / 'list.txt'
    filelist.write_text('a.wav|hello|1\n')
    with pytest.raises(SystemExit, match='needs a download'):
        prepare_main(['spk-emb', '--filelist', str(filelist), '--out',
                      str(tmp_path / 'emb.npy')])
    assert not (tmp_path / 'emb.npy').exists()


# --- lhotse cut manifests (after tests/test_corpus.py) -----------------------


def _cut(cid, wav, text, speaker, start=0.0, dur=2.5):
    return {
        'id': cid, 'start': start, 'duration': dur, 'channel': 0,
        'supervisions': [{'id': cid + '-sup', 'recording_id': cid,
                          'start': 0.0, 'duration': dur, 'channel': 0,
                          'text': text, 'speaker': speaker}],
        'recording': {'id': cid, 'sources': [
            {'type': 'file', 'channels': [0], 'source': wav}],
            'sampling_rate': 16000, 'num_samples': int(dur * 16000),
            'duration': dur},
        'type': 'MonoCut',
    }


def _write_manifest(path, cuts):
    with gzip.open(path, 'wt', encoding='utf-8') as f:
        for c in cuts:
            f.write(json.dumps(c) + '\n')


def _fields(records):
    return [tuple(vars(r).values()) for r in records]


def test_read_cut_manifest_with_transform(tmp_path):
    p = str(tmp_path / 'x_cuts_dev.jsonl.gz')
    _write_manifest(p, [
        _cut('c1', 'audio/a.wav', 'Hello [noise] WORLD  (um) that \'s', 'spkA'),
        _cut('c2', '/abs/b.wav', 'plain text', 'spkB'),
    ])
    recs = tcorpus.read_cut_manifest(p, prefix_path='/data', transform=True)
    assert len(recs) == 2
    # "text": null supervision must not crash the reader
    p2 = str(tmp_path / 'x_cuts_nul.jsonl.gz')
    _write_manifest(p2, [_cut('c3', 'audio/c.wav', None, 'spkC')])
    recs2 = tcorpus.read_cut_manifest(p2, transform=True)
    assert recs2[0].text == ''
    assert recs[0].text == "hello world that's"
    assert recs[0].wav_path == '/data/audio/a.wav'
    assert recs[1].wav_path == '/abs/b.wav'
    assert recs[0].speaker == 'spkA'
    assert recs[0].sampling_rate == 16000
    for path, kw in ((p, dict(prefix_path='/data')), (p2, {})):
        assert _fields(tcorpus.read_cut_manifest(path, **kw)) == \
            _fields(jcorpus.read_cut_manifest(path, **kw))


def test_load_corpus_splits_and_filelist(tmp_path):
    for split in ('train', 'dev', 'test'):
        _write_manifest(str(tmp_path / f'ted_cuts_{split}.jsonl.gz'),
                        [_cut(f'{split}-1', f'{split}/u1.wav',
                              f'{split} text one', 's1'),
                         _cut(f'{split}-2', f'{split}/u2.wav',
                              f'{split} text two', 's2')])
    ds = tcorpus.load_corpus(str(tmp_path), prefix_path='', file_name='ted',
                             transform=False)
    assert set(ds) == {'train', 'dev', 'test'}
    assert len(ds['train']) == 2
    assert ds['dev'][0].text == 'dev text one'
    want = jcorpus.load_corpus(str(tmp_path), prefix_path='',
                               file_name='ted', transform=False)
    assert {k: _fields(v) for k, v in ds.items()} == \
        {k: _fields(v) for k, v in want.items()}

    out = str(tmp_path / 'fl.txt')
    spk_ids = {}
    n = tcorpus.corpus_to_filelist(ds['train'], out, with_speaker=True,
                                   speaker_ids=spk_ids)
    assert n == 2
    lines = open(out).read().splitlines()
    assert lines[0].endswith('|train text one|0')
    assert lines[1].endswith('|train text two|1')
    assert spk_ids == {'s1': 0, 's2': 1}
    jout = str(tmp_path / 'jfl.txt')
    jcorpus.corpus_to_filelist(want['train'], jout, with_speaker=False)
    tcorpus.corpus_to_filelist(ds['train'], out, with_speaker=False)
    assert open(out).read() == open(jout).read()
