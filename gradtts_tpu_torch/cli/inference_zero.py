"""Zero-shot synthesis CLI: a voice from a speaker vector, on the GPU.

Counterpart of gradtts_tpu/cli/inference_zero.py: a zero-speaker model
(``n_spks == -1``, default preset ``tedlium``) synthesizes each text of
``-f`` in the voice of ``--spk-emb`` (a ``.npy`` speaker embedding, [D] or
[1, D], D the preset's ``spk_emb_dim``), prints the RTF, and writes
``sample_{i}.wav`` with ``--vocoder`` (a reference HiFi-GAN ``.pt`` or an
orbax directory of the JAX vocoder trainer), else ``mel_{i}.npy``;
``--plots`` adds ``mel_{i}.png`` and ``mu_{i}.png`` (matplotlib, imported
only then). The noise comes from a generator seeded with ``--seed``. Runs
on ``cuda`` unless ``--cpu`` is given, and fails when no GPU is present
without it.

Not ported: ``-s speaker.wav``, which needs speechbrain's ECAPA encoder
and its weights from the network; it is refused with a pointer to
``--spk-emb``.

Usage:
  python -m gradtts_tpu_torch.cli.inference_zero -f texts.txt -c CKPT \
      --spk-emb emb.npy [-t 10] [-o out] [--preset tedlium] \
      [--vocoder hifigan.pt|DIR [--vocoder-config cfg.json]] [--plots] \
      [--cpu]
"""

import argparse
import os
import time

import numpy as np
import torch

from gradtts_tpu_torch.cli.inference import (load_vocoder, resolve_device,
                                             text_inputs, write_wav)
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS, synthesize
from gradtts_tpu_torch.text import CMUDict
from gradtts_tpu_torch.utils.convert import load_checkpoint


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-f', '--file', required=True)
    parser.add_argument('-c', '--checkpoint', required=True)
    parser.add_argument('-t', '--timesteps', type=int, default=10)
    parser.add_argument('-s', '--speaker', default=None,
                        help='speaker reference wav (needs speechbrain; not '
                             'ported)')
    parser.add_argument('--spk-emb', default=None,
                        help='precomputed speaker embedding (.npy, [D] or '
                             '[1, D])')
    parser.add_argument('-o', '--output', default='out')
    parser.add_argument('--preset', default='tedlium')
    parser.add_argument('--temperature', type=float, default=1.5)
    parser.add_argument('--vocoder', default=None)
    parser.add_argument('--vocoder-config', default=None)
    parser.add_argument('--plots', action='store_true')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the GPU')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if (args.speaker is None) == (args.spk_emb is None):
        parser.error('pass exactly one of -s/--speaker or --spk-emb')
    if args.speaker is not None:
        parser.error('-s/--speaker needs speechbrain\'s ECAPA speaker '
                     'encoder and its weights from the network, which '
                     'gradtts_tpu_torch does not use: compute the '
                     'embedding elsewhere and pass --spk-emb vec.npy')
    cfg = get_config(args.preset)
    if cfg.n_spks != -1:
        parser.error(f'preset {args.preset!r} is not zero-speaker '
                     f'(n_spks={cfg.n_spks})')
    spk = np.load(args.spk_emb).reshape(1, -1).astype(np.float32)
    if spk.shape[1] != cfg.spk_emb_dim:
        parser.error(f'embedding dim {spk.shape[1]} != config spk_emb_dim '
                     f'{cfg.spk_emb_dim}')
    device = resolve_device(args.cpu)
    spk = torch.from_numpy(spk).to(device)

    print('Initializing Grad-TTS...')
    model = GradTTS.from_config(cfg)
    model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
    model = model.to(device).eval()
    vocoder = None
    if args.vocoder:
        print('Initializing HiFi-GAN...')
        vocoder = load_vocoder(args.vocoder, args.vocoder_config, device)
    if args.plots:
        from gradtts_tpu_torch.utils.plotting import save_plot

    with open(args.file, encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()]
    cmu = CMUDict(cfg.data.cmudict_path)
    os.makedirs(args.output, exist_ok=True)
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for i, text in enumerate(texts):
        x, n_ids, y_budget = text_inputs(text, cmu, cfg)
        t0 = time.perf_counter()
        res = synthesize(model, x.to(device),
                         torch.tensor([n_ids], device=device),
                         n_timesteps=args.timesteps, y_max_length=y_budget,
                         temperature=args.temperature, generator=generator,
                         spk=spk)
        frames = int(res.y_lengths[0])
        dt = time.perf_counter() - t0
        print(f'Synthesizing {i} text... Grad-TTS RTF: '
              f'{dt * sr / (frames * hop)}')
        mel = res.decoder_outputs[0, :frames]
        if args.plots:
            save_plot(mel.cpu().numpy().T,
                      os.path.join(args.output, f'mel_{i}.png'))
            save_plot(res.encoder_outputs[0, :frames].cpu().numpy().T,
                      os.path.join(args.output, f'mu_{i}.png'))
        if vocoder is not None:
            write_wav(vocoder, mel, os.path.join(args.output,
                                                 f'sample_{i}.wav'), sr)
        else:
            np.save(os.path.join(args.output, f'mel_{i}.npy'),
                    mel.cpu().numpy())
    print(f'Done. Check out the `{args.output}` folder for samples.')


if __name__ == '__main__':
    main()
