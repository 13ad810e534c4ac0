"""The one traffic generator. A traffic mix is a JSON file of parameters
under ``benchmark/traffic/``; this module turns it, a configuration and a
seed into the inputs of every call, on the device.

Text lengths come from a lengths table (``traffic/lengths/<name>.csv``:
the token ids, blanks interspersed, and the characters of each line of a
public filelist). A batch of B rows takes the rows at the B quantile
midpoints of the table, so every seed runs the same set of sizes; the
seed orders the rows and draws the token ids, the mels, the speakers, the
noise and the probes. A text is a blank between every two of its
phonemes, as the program's front end writes it, with the phoneme ids
drawn uniformly over the symbols (0, the padding, left out).

Mel lengths, where the traffic needs real mels, follow the configuration's
speaking rate: frames = characters / chars_per_second * frames a second.
"""

import csv
import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_traffic(name):
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as f:
        return json.load(f)


def load_lengths(name):
    """[N, 2] int array of (ids, chars), sorted by ids then chars."""
    with open(os.path.join(HERE, 'traffic', 'lengths', f'{name}.csv')) as f:
        rows = [(int(r['ids']), int(r['chars'])) for r in csv.DictReader(f)]
    return np.array(sorted(rows))


def quantile_rows(table, n):
    """The rows of ``table`` at the n quantile midpoints (i + 0.5) / n."""
    idx = ((np.arange(n) + 0.5) / n * len(table)).astype(int)
    return table[np.minimum(idx, len(table) - 1)]


def bucket(length, buckets):
    """The smallest bucket that holds ``length``, or ``length`` itself past
    the last (the program's BatchCollate keeps its own length there)."""
    return next((b for b in buckets if length <= b), length)


def frames_per_second(cfg):
    return cfg['sample_rate'] / cfg['hop_length']


def mel_frames(chars, cfg):
    return int(round(chars / cfg['chars_per_second'] * frames_per_second(cfg)))


class Draws:
    """The seed's draws: a host numpy generator for orders and choices,
    a device torch generator for tensors."""

    def __init__(self, seed, device):
        self.np = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def text(self, n_ids, width, n_vocab):
        """[width] long ids: blank, phoneme, blank, ... of length n_ids,
        zero-padded; phonemes uniform over 1 .. n_vocab - 2."""
        x = torch.zeros(width, dtype=torch.long)
        x[:n_ids:2] = n_vocab - 1
        n_ph = n_ids // 2
        x[1:n_ids:2] = torch.from_numpy(
            self.np.integers(1, n_vocab - 1, n_ph))
        return x

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def rademacher(self, shape):
        return torch.randint(0, 2, shape, generator=self.gen,
                             device=self.device).float() * 2.0 - 1.0


def text_batch(draws, rows, cfg, x_width=None):
    """{'x' [B, Xb], 'x_lengths' [B]} on the device for the (ids, chars)
    ``rows`` in the seed's order; Xb the x bucket of the longest."""
    rows = rows[draws.np.permutation(len(rows))]
    width = x_width or bucket(int(rows[:, 0].max()), cfg['x_buckets'])
    x = torch.stack([draws.text(int(n), width, cfg['n_vocab'])
                     for n in rows[:, 0]])
    return rows, {'x': x.to(draws.device),
                  'x_lengths': torch.from_numpy(rows[:, 0]).to(draws.device)}


def synthesis_batches(traffic, cfg, draws):
    """``traffic['batches']`` batches of texts, noise [B, budget, F] and,
    with speakers, ids [B]."""
    table = load_lengths(traffic['lengths'])
    rows = quantile_rows(table, traffic['batch'])
    out = []
    for _ in range(traffic['batches']):
        _, b = text_batch(draws, rows, cfg)
        b['noise'] = draws.normal((traffic['batch'], traffic['frame_budget'],
                                   cfg['n_feats']))
        if cfg['n_spks'] > 1:
            b['spk'] = torch.from_numpy(draws.np.integers(
                0, cfg['n_spks'], traffic['batch'])).to(draws.device)
        out.append(b)
    return out


def training_batches(traffic, cfg, draws):
    """Batches of texts and seeded mels [B, Yb, F] (N(0, 1) on each row's
    frames, zero past them), Yb the y bucket of the longest."""
    table = load_lengths(traffic['lengths'])
    rows = quantile_rows(table, traffic['batch'])
    out = []
    for _ in range(traffic['batches']):
        r, b = text_batch(draws, rows, cfg)
        frames = np.array([mel_frames(c, cfg) for c in r[:, 1]])
        yb = bucket(int(frames.max()), cfg['y_buckets'])
        y_lengths = torch.from_numpy(frames).to(draws.device)
        mask = torch.arange(yb, device=draws.device)[None] < y_lengths[:, None]
        b['y'] = draws.normal((len(frames), yb, cfg['n_feats'])) \
            * mask[..., None]
        b['y_lengths'] = y_lengths.to(torch.int32)
        b['x_lengths'] = b['x_lengths'].to(torch.int32)
        b['x'] = b['x'].to(torch.int32)
        out.append(b)
    return out


def _edit(draws, base, n_vocab, n_edits):
    """``base`` (a list of ids, blanks interspersed) with ``n_edits``
    phoneme edits: a substitution, a deletion (phoneme and its blank) or an
    insertion (a phoneme and a blank)."""
    ids = list(base)
    for _ in range(n_edits):
        pos = 2 * int(draws.np.integers(0, (len(ids) - 1) // 2)) + 1
        kind = int(draws.np.integers(0, 3))
        phone = int(draws.np.integers(1, n_vocab - 1))
        if kind == 0:
            ids[pos] = phone
        elif kind == 1 and len(ids) > 3:
            del ids[pos:pos + 2]
        else:
            ids[pos:pos] = [phone, n_vocab - 1]
    return ids


def nbest_calls(traffic, cfg, draws):
    """One utterance's n-best list in calls of ``batch`` rows: a seeded base
    text whose length is that of a filelist line of ``base_chars``
    characters, and variants at 1-4 phoneme edits; one seeded mel of that
    line's frames, padded to the frame budget, shared by every row; one
    speaker; a Rademacher probe a call."""
    table = load_lengths(traffic['lengths'])
    lo, hi = traffic['base_chars']
    pick = table[(table[:, 1] >= lo) & (table[:, 1] <= hi)]
    n_ids, chars = pick[int(draws.np.integers(0, len(pick)))]
    nv = cfg['n_vocab']
    base = draws.text(int(n_ids), int(n_ids), nv).tolist()
    hyps = [base] + [_edit(draws, base, nv, int(draws.np.integers(
        traffic['edits'][0], traffic['edits'][1] + 1)))
        for _ in range(traffic['hypotheses'] - 1)]
    width = bucket(max(len(h) for h in hyps), cfg['x_buckets'])
    x = torch.zeros((len(hyps), width), dtype=torch.long)
    for i, h in enumerate(hyps):
        x[i, :len(h)] = torch.tensor(h)
    x_lengths = torch.tensor([len(h) for h in hyps])
    frames = mel_frames(int(chars), cfg)
    budget = traffic['frame_budget']
    dev = draws.device
    y = torch.zeros((1, budget, cfg['n_feats']), device=dev)
    y[:, :frames] = draws.normal((1, frames, cfg['n_feats']))
    spk = int(draws.np.integers(0, cfg['n_spks'])) if cfg['n_spks'] > 1 \
        else None
    B = traffic['batch']
    calls = []
    for s in range(0, len(hyps), B):
        call = {'x': x[s:s + B].to(dev), 'x_lengths': x_lengths[s:s + B].to(dev),
                'y': y.expand(B, -1, -1).contiguous(),
                'y_lengths': torch.full((B,), frames, device=dev),
                'epsilon': draws.rademacher((B, budget, cfg['n_feats']))}
        if spk is not None:
            call['spk'] = torch.full((B,), spk, device=dev)
        calls.append(call)
    return calls


GENERATORS = {'synthesize': synthesis_batches, 'generate': synthesis_batches,
              'train': training_batches, 'score': nbest_calls}


def make_inputs(traffic, cfg, seed, device):
    """The inputs of every distinct call of the mix, from ``seed``."""
    return GENERATORS[traffic['drive']](traffic, cfg, Draws(seed, device))
