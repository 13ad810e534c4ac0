"""Datasets, batch collation with static-shape buckets, and the data loader.

The port's own copy of gradtts_tpu/data/dataset.py: ``parse_filelist``
(:31), ``load_wav`` (:36), ``wav_header`` (:64), the TED-LIUM text
normalizer ``transform_txt`` (:109), ``TextMelDataset`` (:122-193), the
speaker datasets ``TextMelSpeakerDataset`` (:196) and
``TextMelZeroSpeakerDataset`` (:211) with ``_load_embedding_matrix``
(:234), ``BatchCollate`` with its ``spk`` field (:248-315), ``DataLoader``
(:430-578) and ``dataset_from_config`` (:581). Mels are computed on the
host by numpy worker threads; batches are numpy dicts padded to bucketed
shapes, so the U-Net meets a handful of shapes. Not ported: the on-device
mel path (``device_mel``) and the per-host ``shard``.
"""

import queue as queue_mod
import random
import re
import threading
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from gradtts_tpu_torch.config import (GradTTSConfig, bucket_length,
                                      fix_len_compatibility)
from gradtts_tpu_torch.data.mel import mel_spectrogram_np
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

    def get_mel(self, filepath):
        audio, sr = load_wav(filepath)
        if sr != self.sample_rate:
            raise ValueError(f'{filepath}: sample rate {sr} != '
                             f'{self.sample_rate}')
        return mel_spectrogram_np(audio[None], self.n_fft, self.n_mels,
                                  self.sample_rate, self.hop_length,
                                  self.win_length, self.f_min, self.f_max)[0]

    def __getitem__(self, index):
        path, text = self.filepaths_and_text[index][:2]
        return {'x': self.get_text(text), 'y': self.get_mel(path)}

    def __len__(self):
        return len(self.filepaths_and_text)


class TextMelSpeakerDataset(TextMelDataset):
    """Filelist lines ``wav|text|speaker_id``; items gain 'spk', the id as
    int32 [1]."""

    def __getitem__(self, index):
        path, text, speaker = self.filepaths_and_text[index][:3]
        return {'x': self.get_text(text), 'y': self.get_mel(path),
                'spk': np.asarray([int(speaker)], dtype=np.int32)}


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


class BatchCollate:
    """Pads a list of items to bucketed static shapes: {'x': [B, Xb] int32,
    'x_lengths': [B], 'y': [B, Yb, F] f32, 'y_lengths': [B]}, Yb a multiple
    of 4; a batch longer than the last bucket keeps its own length. Items
    with 'spk' add 'spk': int32 ids [B], or f32 vectors [B, D]."""

    def __init__(self, x_buckets=(64, 128, 192, 256, 384, 512),
                 y_buckets=(128, 256, 384, 512, 768, 1024, 1536, 2048)):
        self.x_buckets = x_buckets
        self.y_buckets = [fix_len_compatibility(b) for b in y_buckets]

    def shapes_for(self, x_max: int, y_max: int):
        y_max = fix_len_compatibility(y_max)
        return (max(bucket_length(x_max, self.x_buckets), x_max),
                max(bucket_length(y_max, self.y_buckets), y_max))

    def __call__(self, batch: List[Dict]) -> Dict[str, np.ndarray]:
        xb, yb = self.shapes_for(max(item['x'].shape[-1] for item in batch),
                                 max(item['y'].shape[0] for item in batch))
        B, n_feats = len(batch), batch[0]['y'].shape[-1]
        x = np.zeros((B, xb), np.int32)
        y = np.zeros((B, yb, n_feats), np.float32)
        x_lengths = np.zeros((B,), np.int32)
        y_lengths = np.zeros((B,), np.int32)
        for i, item in enumerate(batch):
            xi, yi = item['x'], item['y']
            x[i, :xi.shape[-1]] = xi
            y[i, :yi.shape[0]] = yi
            x_lengths[i], y_lengths[i] = xi.shape[-1], yi.shape[0]
        out = {'x': x, 'x_lengths': x_lengths, 'y': y,
               'y_lengths': y_lengths}
        if 'spk' in batch[0]:
            if np.asarray(batch[0]['spk']).dtype.kind in 'iu':
                out['spk'] = np.array([int(np.asarray(b['spk']).reshape(-1)[0])
                                       for b in batch], np.int32)
            else:
                out['spk'] = np.stack([np.asarray(b['spk'], np.float32)
                                       .reshape(-1) for b in batch])
        return out


class DataLoader:
    """Epoch iterator with background prefetch: a thread pool fetches items
    (wav decode + numpy mel), batches are collated and queued ahead of the
    training step. Each epoch shuffles with ``seed + epoch``; ``drop_last``
    drops a short last batch. Decoded items are kept across epochs up to
    ``cache_bytes`` (no eviction), so later epochs skip the decode."""

    def __init__(self, dataset, batch_size, collate: BatchCollate,
                 shuffle=True, seed=0, drop_last=True, num_workers=4,
                 prefetch=2, cache_bytes: int = 1 << 30):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.cache_bytes = cache_bytes
        self._epoch = 0
        self._cache: Dict[int, Dict] = {}
        self._cache_size = 0
        self._cache_lock = threading.Lock()

    def _fetch(self, index: int) -> Dict:
        with self._cache_lock:
            item = self._cache.get(index)
        if item is not None:
            return item
        item = self.dataset[index]
        size = sum(v.nbytes for v in item.values())
        with self._cache_lock:
            if self._cache_size + size <= self.cache_bytes:
                self._cache[index] = item
                self._cache_size += size
        return item

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
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx_batch in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self._fetch,
                                              [int(i) for i in idx_batch]))
                        q.put(self.collate(items))
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
