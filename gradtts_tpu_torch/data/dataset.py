"""Datasets, batch collation with static-shape buckets, and the data loader.

The port's own copy of gradtts_tpu/data/dataset.py: ``parse_filelist``
(:31), ``load_wav`` (:36), ``wav_header`` (:64), the TED-LIUM text
normalizer ``transform_txt`` (:109), ``TextMelDataset`` with its raw-audio
items and ``item_lengths`` (:122-193), the speaker datasets
``TextMelSpeakerDataset`` (:196) and ``TextMelZeroSpeakerDataset`` (:211)
with ``_load_embedding_matrix`` (:234), ``BatchCollate`` (:248-315),
``DeviceMelCollate`` (:318-427), ``DataLoader`` with ``device_mel`` and the
per-process ``shard`` (:430-578) and ``dataset_from_config`` (:581).
Batches are padded to bucketed shapes, so the U-Net meets a handful of
shapes. Host mels are computed by numpy worker threads; with
``device_mel`` the loader collates raw audio and computes the mels on the
device (``DeviceMelCollate``).
"""

import queue as queue_mod
import random
import re
import threading
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from gradtts_tpu_torch.config import (GradTTSConfig, bucket_length,
                                      fix_len_compatibility)
from gradtts_tpu_torch.data.mel import mel_from_padded, mel_spectrogram_np
from gradtts_tpu_torch.text import CMUDict, intersperse_blank, text_to_sequence
from gradtts_tpu_torch.text.symbols import symbols


def parse_filelist(filelist_path, split_char='|'):
    with open(filelist_path, encoding='utf-8') as f:
        return [line.strip().split(split_char) for line in f if line.strip()]


def load_wav(path):
    """(waveform float32 in [-1, 1], sample rate) of a PCM16/32, uint8 or
    float32 WAV file; the first channel of a multichannel one."""
    try:
        from scipy.io import wavfile
    except ImportError:
        wavfile = None
    if wavfile is not None:
        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32)
        return (data[:, 0] if data.ndim > 1 else data), sr
    with wave.open(path, 'rb') as w:
        sr = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()),
                             dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels())[:, 0]
        return data, sr


def wav_header(path):
    """(n_samples, sample_rate) from the RIFF header alone."""
    with open(path, 'rb') as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b'RIFF' or riff[8:12] != b'WAVE':
            raise ValueError(f'{path}: not a RIFF/WAVE file')
        sr = block_align = data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], int.from_bytes(hdr[4:8], 'little')
            if cid == b'fmt ':
                fmt = f.read(size)
                sr = int.from_bytes(fmt[4:8], 'little')
                block_align = int.from_bytes(fmt[12:14], 'little')
            elif cid == b'data':
                data_size = size
                break
            else:
                f.seek(size + (size & 1), 1)
        if sr is None or not block_align or data_size is None:
            raise ValueError(f'{path}: malformed WAV header')
        return data_size // block_align, sr


# --- the TED-LIUM text normalizer ---------------------------------------------

_TED_BRACKETS = [re.compile(p) for p in
                 (r'\[.*?\]', r'\(.*?\)', r'<.*?>', r'\{.*?\}')]
_TED_SPACES = re.compile(r' +')


def transform_txt(txt: str) -> str:
    """Lower case, bracketed tags ([..], (..), <..>, {..}) removed, runs of
    spaces collapsed, and the space before an apostrophe dropped."""
    txt = txt.lower()
    for pat in _TED_BRACKETS:
        txt = pat.sub('', txt)
    txt = _TED_SPACES.sub(' ', txt.strip())
    return txt.replace(" '", "'")


class TextMelDataset:
    """(wav path, text) filelist -> {'x': token ids, 'y': log-mel [T, 80]}.
    The filelist is shuffled once with ``seed``, as in the JAX package."""

    def __init__(self, filelist_path, cmudict_path, add_blank=True,
                 n_fft=1024, n_mels=80, sample_rate=22050, hop_length=256,
                 win_length=1024, f_min=0.0, f_max=8000.0, shuffle=True,
                 seed=37, split_char='|'):
        self.filepaths_and_text = parse_filelist(filelist_path, split_char)
        self.cmudict = CMUDict(cmudict_path)
        self.add_blank = add_blank
        self.n_fft, self.n_mels = n_fft, n_mels
        self.sample_rate, self.hop_length = sample_rate, hop_length
        self.win_length, self.f_min, self.f_max = win_length, f_min, f_max
        if shuffle:
            random.Random(seed).shuffle(self.filepaths_and_text)

    def get_text(self, text):
        ids = text_to_sequence(text, dictionary=self.cmudict)
        if self.add_blank:
            ids = intersperse_blank(ids, len(symbols))
        return np.asarray(ids, dtype=np.int32)

    def get_audio(self, filepath):
        audio, sr = load_wav(filepath)
        if sr != self.sample_rate:
            raise ValueError(f'{filepath}: sample rate {sr} != '
                             f'{self.sample_rate}')
        return audio

    def get_mel(self, filepath):
        return mel_spectrogram_np(
            self.get_audio(filepath)[None], self.n_fft, self.n_mels,
            self.sample_rate, self.hop_length, self.win_length, self.f_min,
            self.f_max)[0]

    def __getitem__(self, index):
        path, text = self.filepaths_and_text[index][:2]
        return {'x': self.get_text(text), 'y': self.get_mel(path)}

    def audio_item(self, index):
        """Like ``__getitem__`` with the raw audio ('audio') in place of
        the mel, for ``DeviceMelCollate``."""
        path, text = self.filepaths_and_text[index][:2]
        return {'x': self.get_text(text), 'audio': self.get_audio(path)}

    def item_lengths(self, index):
        """(token count, mel frame count) of item ``index`` from its text
        and its WAV header, without decoding the audio; equal to the
        shapes ``__getitem__`` gives."""
        path, text = self.filepaths_and_text[index][:2]
        n_samples, sr = wav_header(path)
        if sr != self.sample_rate:
            raise ValueError(f'{path}: sample rate {sr} != '
                             f'{self.sample_rate}')
        pad = (self.n_fft - self.hop_length) // 2
        n_frames = 1 + (n_samples + 2 * pad - self.n_fft) // self.hop_length
        return len(self.get_text(text)), n_frames

    def __len__(self):
        return len(self.filepaths_and_text)

    def sample_test_batch(self, size, seed=0):
        """``size`` distinct items, the trainer's previews: the indices of
        ``default_rng(seed).choice``, as the JAX package picks them."""
        idx = np.random.default_rng(seed).choice(len(self), size=size,
                                                 replace=False)
        return [self[int(i)] for i in idx]


class TextMelSpeakerDataset(TextMelDataset):
    """Filelist lines ``wav|text|speaker_id``; items gain 'spk', the id as
    int32 [1]."""

    def __getitem__(self, index):
        path, text, speaker = self.filepaths_and_text[index][:3]
        return {'x': self.get_text(text), 'y': self.get_mel(path),
                'spk': np.asarray([int(speaker)], dtype=np.int32)}

    def audio_item(self, index):
        item = super().audio_item(index)
        item['spk'] = np.asarray([int(self.filepaths_and_text[index][2])],
                                 dtype=np.int32)
        return item


class TextMelZeroSpeakerDataset(TextMelDataset):
    """A ``wav|text`` filelist and a matrix of pretrained speaker vectors,
    one row an utterance in the filelist's order (``.npy``, ``.npz`` or a
    torch ``.pt`` tensor); items gain 'spk', the row as f32. Not shuffled
    unless asked, so rows and lines stay paired."""

    def __init__(self, filelist_path, spk_path, cmudict_path,
                 spk_emb_dim=192, **kw):
        kw.setdefault('shuffle', False)
        super().__init__(filelist_path, cmudict_path, **kw)
        self.spk_emb = _load_embedding_matrix(spk_path)
        self.spk_emb_dim = spk_emb_dim

    def __getitem__(self, index):
        path, text = self.filepaths_and_text[index][:2]
        return {'x': self.get_text(text), 'y': self.get_mel(path),
                'spk': np.asarray(self.spk_emb[index], dtype=np.float32)}

    def audio_item(self, index):
        item = super().audio_item(index)
        item['spk'] = np.asarray(self.spk_emb[index], dtype=np.float32)
        return item


def _load_embedding_matrix(path):
    """The speaker-vector matrix of a ``.npy`` file, the first array of a
    ``.npz`` file or a torch tensor saved as ``.pt``."""
    if path.endswith('.npy'):
        return np.load(path)
    if path.endswith('.npz'):
        with np.load(path) as data:
            return data[data.files[0]]
    import torch
    t = torch.load(path, map_location='cpu', weights_only=True)
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, 'detach')
                      else t)


def dataset_from_config(cfg: GradTTSConfig, split: str = 'train'):
    """The dataset of a preset's ``split`` ('train', 'valid' or 'test'):
    speaker vectors for ``n_spks == -1``, speaker ids for ``n_spks > 1``,
    else text and mel."""
    d = cfg.data
    path = {'train': d.train_filelist_path, 'valid': d.valid_filelist_path,
            'test': d.test_filelist_path}[split]
    kw = dict(n_fft=d.n_fft, n_mels=d.n_feats, sample_rate=d.sample_rate,
              hop_length=d.hop_length, win_length=d.win_length,
              f_min=d.f_min, f_max=d.f_max, add_blank=d.add_blank,
              seed=cfg.train.seed)
    if cfg.n_spks == -1:
        spk_path = {'train': d.train_spk_path, 'valid': d.valid_spk_path,
                    'test': d.test_spk_path}[split]
        return TextMelZeroSpeakerDataset(path, spk_path, d.cmudict_path,
                                         spk_emb_dim=cfg.spk_emb_dim, **kw)
    if cfg.n_spks > 1:
        return TextMelSpeakerDataset(path, d.cmudict_path, **kw)
    return TextMelDataset(path, d.cmudict_path, **kw)


def _collate_text_and_speakers(batch: List[Dict], xb: int) -> Dict:
    """'x' [B, xb] int32, 'x_lengths' [B] and, where the items have them,
    'spk': int32 ids [B], or f32 vectors [B, D]."""
    x = np.zeros((len(batch), xb), np.int32)
    x_lengths = np.zeros((len(batch),), np.int32)
    for i, item in enumerate(batch):
        x[i, :item['x'].shape[-1]] = item['x']
        x_lengths[i] = item['x'].shape[-1]
    out = {'x': x, 'x_lengths': x_lengths}
    if 'spk' in batch[0]:
        if np.asarray(batch[0]['spk']).dtype.kind in 'iu':
            out['spk'] = np.array([int(np.asarray(b['spk']).reshape(-1)[0])
                                   for b in batch], np.int32)
        else:
            out['spk'] = np.stack([np.asarray(b['spk'], np.float32)
                                   .reshape(-1) for b in batch])
    return out


def _check_shapes(shapes, x_max: int, y_max: int):
    """Batch shapes given from the global batch's ``item_lengths`` must
    cover the local items."""
    if shapes[0] < x_max or shapes[1] < y_max:
        raise ValueError(
            f'provided batch shapes {tuple(shapes)} smaller than local '
            f'maxima ({x_max}, {y_max}): item_lengths metadata disagrees '
            'with actual items')


class BatchCollate:
    """Pads a list of items to bucketed static shapes: {'x': [B, Xb] int32,
    'x_lengths': [B], 'y': [B, Yb, F] f32, 'y_lengths': [B]}, Yb a multiple
    of 4; a batch longer than the last bucket keeps its own length. Items
    with 'spk' add 'spk': int32 ids [B], or f32 vectors [B, D]. ``shapes``
    (Xb, Yb) replaces the buckets (a sharded loader's global shapes)."""

    def __init__(self, x_buckets=(64, 128, 192, 256, 384, 512),
                 y_buckets=(128, 256, 384, 512, 768, 1024, 1536, 2048)):
        self.x_buckets = x_buckets
        self.y_buckets = [fix_len_compatibility(b) for b in y_buckets]

    def shapes_for(self, x_max: int, y_max: int):
        """(Xb, Yb) for the batch's longest text and mel; the same maxima
        give the same shapes in every process."""
        y_max = fix_len_compatibility(y_max)
        return (max(bucket_length(x_max, self.x_buckets), x_max),
                max(bucket_length(y_max, self.y_buckets), y_max))

    def __call__(self, batch: List[Dict],
                 shapes: Optional[tuple] = None) -> Dict[str, np.ndarray]:
        x_max = max(item['x'].shape[-1] for item in batch)
        y_max = max(item['y'].shape[0] for item in batch)
        if shapes is not None:
            _check_shapes(shapes, x_max, fix_len_compatibility(y_max))
            xb, yb = shapes
        else:
            xb, yb = self.shapes_for(x_max, y_max)
        B, n_feats = len(batch), batch[0]['y'].shape[-1]
        y = np.zeros((B, yb, n_feats), np.float32)
        y_lengths = np.zeros((B,), np.int32)
        for i, item in enumerate(batch):
            y[i, :item['y'].shape[0]] = item['y']
            y_lengths[i] = item['y'].shape[0]
        out = _collate_text_and_speakers(batch, xb)
        out.update(y=y, y_lengths=y_lengths)
        return out


class DeviceMelCollate:
    """Collates raw-audio items ('x', 'audio'(, 'spk')) and computes their
    log-mels on ``device`` in one batched call of ``mel_from_padded``.

    The batch dict equals :class:`BatchCollate`'s (the same bucket shapes,
    the same lengths, the mel values to f32 FFT precision, tail frames 0),
    with 'y' a tensor on ``device`` and the other fields numpy. Each
    utterance is reflect-padded on the host, so its edge frames see its
    own reflection as in the host path, then the batch is zero-padded to
    S = (Yb - 1) * hop + n_fft samples, which give exactly Yb frames.

    ``upload_dtype='int16'`` sends the padded audio as PCM16, half the
    bytes of float32; exact for PCM16 sources (``load_wav``'s i / 32768
    rounds back to i), one -96 dB quantization for float ones.

    The device work runs on the device's current stream of the calling
    thread (the loader's producer thread: the default stream, which the
    training step shares, so the order holds). The upload is
    ``non_blocking`` from pinned memory; PyTorch's pinned-memory cache
    keeps the buffer until the copy is done.
    """

    def __init__(self, base: BatchCollate, device, n_fft=1024, n_mels=80,
                 sample_rate=22050, hop_length=256, win_length=1024,
                 f_min=0.0, f_max=8000.0, upload_dtype='float32'):
        if upload_dtype not in ('float32', 'int16'):
            raise ValueError(f'upload_dtype {upload_dtype!r}: float32 or '
                             'int16')
        self.base = base
        self.device = torch.device(device)
        self.n_fft, self.n_mels = n_fft, n_mels
        self.sample_rate, self.hop_length = sample_rate, hop_length
        self.win_length, self.f_min, self.f_max = win_length, f_min, f_max
        self.upload_dtype = upload_dtype

    @classmethod
    def for_dataset(cls, dataset, base: BatchCollate, device,
                    upload_dtype='float32'):
        """The collate with ``dataset``'s mel settings."""
        return cls(base, device, n_fft=dataset.n_fft, n_mels=dataset.n_mels,
                   sample_rate=dataset.sample_rate,
                   hop_length=dataset.hop_length,
                   win_length=dataset.win_length, f_min=dataset.f_min,
                   f_max=dataset.f_max, upload_dtype=upload_dtype)

    def shapes_for(self, x_max: int, y_max: int):
        return self.base.shapes_for(x_max, y_max)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(array)
        if self.device.type == 'cuda':
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def __call__(self, batch: List[Dict],
                 shapes: Optional[tuple] = None) -> Dict:
        hop, n_fft = self.hop_length, self.n_fft
        pad = (n_fft - hop) // 2
        y_lengths = np.array(
            [1 + (item['audio'].shape[-1] + 2 * pad - n_fft) // hop
             for item in batch], np.int32)
        x_max = max(item['x'].shape[-1] for item in batch)
        if shapes is not None:
            _check_shapes(shapes, x_max, int(y_lengths.max()))
            xb, yb = shapes
        else:
            xb, yb = self.base.shapes_for(x_max, int(y_lengths.max()))
        S = (yb - 1) * hop + n_fft
        int16 = self.upload_dtype == 'int16'
        audio = np.zeros((len(batch), S), np.int16 if int16 else np.float32)
        for i, item in enumerate(batch):
            a = np.pad(np.asarray(item['audio'], np.float32), (pad, pad),
                       mode='reflect')
            if a.shape[-1] > S:
                raise ValueError(
                    f'item {i}: padded audio length {a.shape[-1]} exceeds '
                    f'the {S}-sample bucket: item_lengths metadata '
                    'disagrees with actual items')
            if int16:
                a = np.clip(np.round(a * 32768.0), -32768, 32767)
            audio[i, :a.shape[-1]] = a
        y = mel_from_padded(
            self._upload(audio), self._upload(y_lengths), n_fft=n_fft,
            num_mels=self.n_mels, sampling_rate=self.sample_rate,
            hop_size=hop, win_size=self.win_length, fmin=self.f_min,
            fmax=self.f_max)
        out = _collate_text_and_speakers(batch, xb)
        out.update(y=y, y_lengths=y_lengths)
        return out


class DataLoader:
    """Epoch iterator with background prefetch: a thread pool fetches items
    (wav decode + numpy mel), batches are collated and queued ahead of the
    training step. Each epoch shuffles with ``seed + epoch``; ``drop_last``
    drops a short last batch. Decoded items are kept across epochs up to
    ``cache_bytes`` (no eviction), so later epochs skip the decode.

    ``device_mel=True`` fetches raw audio (``dataset.audio_item``) and
    computes the mels on ``device`` with :class:`DeviceMelCollate`
    (``mel_upload_dtype`` its wire format). ``batch_size`` is the global
    batch; ``shard=(index, count)`` loads only this process's contiguous
    ``batch_size / count`` rows of each global batch, every process in the
    same shuffled order, with batch shapes from the global batch's maxima
    (``dataset.item_lengths``), so all processes collate equal shapes."""

    def __init__(self, dataset, batch_size, collate: BatchCollate,
                 shuffle=True, seed=0, drop_last=True, num_workers=4,
                 prefetch=2, cache_bytes: int = 1 << 30, shard=None,
                 device_mel=False, mel_upload_dtype: str = 'float32',
                 device=None):
        if device_mel and not isinstance(collate, DeviceMelCollate):
            if device is None:
                raise ValueError('device_mel=True needs the device that '
                                 'computes the mels')
            collate = DeviceMelCollate.for_dataset(
                dataset, collate, device, upload_dtype=mel_upload_dtype)
        if shard is not None:
            index, count = shard
            if not 0 <= index < count:
                raise ValueError(f'bad shard {shard}')
            if batch_size % count:
                raise ValueError(f'global batch {batch_size} not divisible '
                                 f'by shard count {count}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.device_mel = device_mel
        self.shard = shard
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.cache_bytes = cache_bytes
        self._epoch = 0
        self._lengths = None
        self._cache: Dict[int, Dict] = {}
        self._cache_size = 0
        self._cache_lock = threading.Lock()

    def _fetch(self, index: int) -> Dict:
        with self._cache_lock:
            item = self._cache.get(index)
        if item is not None:
            return item
        item = (self.dataset.audio_item(index) if self.device_mel
                else self.dataset[index])
        size = sum(v.nbytes for v in item.values())
        with self._cache_lock:
            if self._cache_size + size <= self.cache_bytes:
                self._cache[index] = item
                self._cache_size += size
        return item

    def _item_lengths(self) -> np.ndarray:
        """[N, 2] (token count, mel frames) of every item, from texts and
        WAV headers; computed once."""
        if self._lengths is None:
            with ThreadPoolExecutor(max(4, self.num_workers)) as pool:
                self._lengths = np.array(
                    list(pool.map(self.dataset.item_lengths,
                                  range(len(self.dataset)))), np.int64)
        return self._lengths

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last or self.shard is not None:
            batches = [b for b in batches if len(b) == self.batch_size]
        shapes = [None] * len(batches)
        if self.shard is not None:
            lengths = self._item_lengths()
            shapes = [self.collate.shapes_for(int(lengths[b, 0].max()),
                                              int(lengths[b, 1].max()))
                      for b in batches]
            index, count = self.shard
            local = self.batch_size // count
            batches = [b[index * local:(index + 1) * local] for b in batches]

        q = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx_batch, shape in zip(batches, shapes):
                        if stop.is_set():
                            return
                        items = list(pool.map(self._fetch,
                                              [int(i) for i in idx_batch]))
                        q.put(self.collate(items) if shape is None
                              else self.collate(items, shapes=shape))
            except Exception as e:      # surfaced to the consumer below
                q.put(e)
            finally:
                q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # let a producer blocked on a full queue see the stop
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    worker.join(0.05)
