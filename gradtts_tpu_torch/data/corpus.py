"""Lhotse-manifest corpus reader (dependency-free).

Behavioral parity target: upstream data.py:274-286 (``load_corpus``)
— loads lhotse CutSet manifests ``{name}_cuts_{split}.jsonl.gz`` for the
train/dev/test splits, re-prefixes recording paths, and applies the
TED-LIUM text normalizer. The reference needs the lhotse package; cut
manifests are plain JSON-lines, so this module parses them directly (no
heavyweight dependency in the input pipeline) into lightweight records the
datasets and filelist builders consume.

The port's own copy of gradtts_tpu/data/corpus.py: the same numpy code, its
imports from gradtts_tpu_torch.
"""

import gzip
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from gradtts_tpu_torch.data.dataset import transform_txt


@dataclass(frozen=True)
class CutRecord:
    """One utterance cut from a lhotse manifest."""
    cut_id: str
    wav_path: str
    text: str
    speaker: Optional[str]
    start: float
    duration: float
    sampling_rate: Optional[int] = None


def _first_source_path(recording: dict) -> Optional[str]:
    for src in recording.get('sources', []):
        if src.get('type') in (None, 'file'):
            return src.get('source')
    return None


def read_cut_manifest(path: str, prefix_path: str = '',
                      transform: bool = True) -> List[CutRecord]:
    """Parse one ``*_cuts_*.jsonl.gz`` (or plain ``.jsonl``) manifest."""
    opener = gzip.open if path.endswith('.gz') else open
    records = []
    with opener(path, 'rt', encoding='utf-8') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cut = json.loads(line)
            rec = cut.get('recording', {})
            wav = _first_source_path(rec)
            if wav is None:
                continue
            if prefix_path and not os.path.isabs(wav):
                # lhotse with_recording_path_prefix semantics
                # (Path(prefix) / source): absolute source paths are left
                # untouched, relative ones get the prefix
                wav = os.path.join(prefix_path, wav)
            sups = cut.get('supervisions', [])
            # "text": null is legal in lhotse manifests
            text = ' '.join(s.get('text') or '' for s in sups).strip()
            if transform:
                text = transform_txt(text)
            speaker = sups[0].get('speaker') if sups else None
            records.append(CutRecord(
                cut_id=cut.get('id', ''),
                wav_path=wav,
                text=text,
                speaker=speaker,
                start=float(cut.get('start', 0.0)),
                duration=float(cut.get('duration', 0.0)),
                sampling_rate=rec.get('sampling_rate')))
    return records


def load_corpus(target_folder: str, prefix_path: str = '',
                file_name: str = 'tedlium', transform: bool = True,
                splits=('train', 'dev', 'test')) -> Dict[str, List[CutRecord]]:
    """Parity: data.py:274-286 — {split: [CutRecord]} from
    ``{target_folder}/{file_name}_cuts_{split}.jsonl.gz``."""
    ds = {}
    for split in splits:
        path = os.path.join(target_folder,
                            f'{file_name}_cuts_{split}.jsonl.gz')
        if not os.path.exists(path):
            alt = path[:-3]
            path = alt if os.path.exists(alt) else path
        ds[split] = read_cut_manifest(path, prefix_path, transform)
    return ds


def corpus_to_filelist(records: List[CutRecord], out_path: str,
                       with_speaker: bool = False,
                       speaker_ids: Optional[Dict[str, int]] = None) -> int:
    """Write records as a ``wav|text[|spk]`` filelist for the datasets.
    Returns the number of lines written; ``speaker_ids`` is filled (or
    extended) with a stable name -> integer mapping when with_speaker."""
    n = 0
    with open(out_path, 'w', encoding='utf-8') as f:
        for r in records:
            if not r.text:
                continue
            if with_speaker:
                if speaker_ids is None:
                    speaker_ids = {}
                spk = speaker_ids.setdefault(r.speaker or '',
                                             len(speaker_ids))
                f.write(f'{r.wav_path}|{r.text}|{spk}\n')
            else:
                f.write(f'{r.wav_path}|{r.text}\n')
            n += 1
    return n
