"""Dataset preparation CLI: TED-LIUM segmentation and filelists, host-side.

Counterpart of gradtts_tpu/cli/prepare.py (the same subcommands and
flags), which rebuilds the reference's prep scripts (upstream scripts/):

  tedlium-segment   tedlium_manifest.py — STM + SPH dirs -> per-utterance
                    wavs named {spk_id}_{start}-{end}.wav + speaker_dict.txt
  tedlium-filelist  ted_lium_filelist.py — STM dir + wav dir ->
                    ``wav|text|spk_id`` filelist
  spk-emb           spk_emb.py — ECAPA speaker embeddings for a filelist;
                    refused here: the ECAPA weights need a download (as
                    ``cli.inference_zero -s`` is refused). Give the
                    zero-speaker datasets a matrix made elsewhere.

Each of the first two prints one line per STM file it reads (the JAX CLI
shows a tqdm bar instead).

  python -m gradtts_tpu_torch.cli.prepare tedlium-segment --sph-dir D \
      --stm-dir S --out-dir W
  python -m gradtts_tpu_torch.cli.prepare tedlium-filelist --stm-dir S \
      --wav-dir W --speaker-dict W/speaker_dict.txt --out train.txt
"""

import argparse
import os
import re


def _parse_stm_line(line):
    """STM: <file> <channel> <speaker> <start> <end> <label> <words...>."""
    parts = line.strip().split()
    if len(parts) < 7:
        return None
    recording = parts[0]
    speaker_name = parts[0].split('_')[0]
    start, end = float(parts[3]), float(parts[4])
    text = ' '.join(parts[6:])
    return recording, speaker_name, start, end, text


def _stm_files(stm_dir):
    """The ``.stm`` names of ``stm_dir`` in sorted order, one line printed
    for each as it is handed out."""
    names = [f for f in sorted(os.listdir(stm_dir)) if f.endswith('.stm')]
    for k, name in enumerate(names):
        print(f'[{k + 1}/{len(names)}] {name}', flush=True)
        yield name


def _wav_name(speaker_id, start, end):
    """{spk}_{start}-{end}.wav with '.' -> '_' in the times (parity:
    ted_lium_filelist.py:30-31)."""
    name = f'{speaker_id}_{start}-{end}.wav'
    return re.sub(r'(\d+)\.(\d+)', r'\1_\2', name)


def cmd_tedlium_segment(args):
    from gradtts_tpu_torch.data.sph import sph_segment_to_wav

    os.makedirs(args.out_dir, exist_ok=True)
    speaker_dict = {}
    counter = 0
    for stm_file in _stm_files(args.stm_dir):
        with open(os.path.join(args.stm_dir, stm_file)) as f:
            for line in f:
                parsed = _parse_stm_line(line)
                if parsed is None:
                    continue
                recording, speaker_name, start, end, text = parsed
                if 'ignore_time_segment' in text:
                    continue
                if speaker_name not in speaker_dict:
                    counter += 1
                    speaker_dict[speaker_name] = counter
                spk_id = speaker_dict[speaker_name]
                sph_path = os.path.join(args.sph_dir, f'{recording}.sph')
                wav_path = os.path.join(args.out_dir,
                                        _wav_name(spk_id, start, end))
                if not os.path.exists(wav_path):
                    sph_segment_to_wav(sph_path, wav_path, start, end)
    dict_path = os.path.join(args.out_dir, 'speaker_dict.txt')
    with open(dict_path, 'w') as f:
        for name, spk_id in speaker_dict.items():
            f.write(f'{spk_id}: {name}\n')
    print(f'{counter} speakers -> {dict_path}')


def _load_speaker_dict(path):
    mapping = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            spk_id, name = line.strip().split(':', 1)
            mapping[name.strip()] = spk_id.strip()
    return mapping


def cmd_tedlium_filelist(args):
    from gradtts_tpu_torch.data.dataset import transform_txt

    speakers = _load_speaker_dict(args.speaker_dict)
    n_written = n_skipped = 0
    with open(args.out, 'w') as out:
        for stm_file in _stm_files(args.stm_dir):
            with open(os.path.join(args.stm_dir, stm_file)) as f:
                for line in f:
                    parsed = _parse_stm_line(line)
                    if parsed is None:
                        continue
                    _rec, speaker_name, start, end, text = parsed
                    if 'ignore_time_segment' in text:
                        continue
                    spk_id = speakers.get(speaker_name)
                    if spk_id is None:
                        n_skipped += 1
                        continue
                    text = transform_txt(text)
                    if not text:
                        n_skipped += 1
                        continue
                    wav_path = os.path.join(args.wav_dir,
                                            _wav_name(spk_id, start, end))
                    if args.require_wav and not os.path.exists(wav_path):
                        n_skipped += 1
                        continue
                    out.write(f'{wav_path}|{text}|{spk_id}\n')
                    n_written += 1
    print(f'wrote {n_written} lines ({n_skipped} skipped) -> {args.out}')


def cmd_spk_emb(args):
    raise SystemExit(
        'prepare spk-emb is not available in gradtts_tpu_torch: the ECAPA '
        'speaker encoder (speechbrain/spkrec-ecapa-voxceleb) needs a '
        'download. Compute the embeddings elsewhere and give the dataset '
        'the .npy matrix (one row an utterance of the filelist).')


def main(argv=None):
    parser = argparse.ArgumentParser(prog='gradtts_tpu_torch.cli.prepare')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p = sub.add_parser('tedlium-segment')
    p.add_argument('--sph-dir', required=True)
    p.add_argument('--stm-dir', required=True)
    p.add_argument('--out-dir', required=True)
    p.set_defaults(fn=cmd_tedlium_segment)

    p = sub.add_parser('tedlium-filelist')
    p.add_argument('--stm-dir', required=True)
    p.add_argument('--wav-dir', required=True)
    p.add_argument('--speaker-dict', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--require-wav', action='store_true',
                   help='skip lines whose wav is missing on disk')
    p.set_defaults(fn=cmd_tedlium_filelist)

    p = sub.add_parser('spk-emb')
    p.add_argument('--filelist', required=True)
    p.add_argument('--out', required=True)
    p.set_defaults(fn=cmd_spk_emb)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
