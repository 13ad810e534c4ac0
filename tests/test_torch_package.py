"""Package rules of gradtts_tpu_torch: it imports neither JAX nor the JAX
package, its entry points (synthesis, n-best scoring) never fall back to
the CPU, it builds every preset of the JAX package and loads its weights,
and its CPU paths launch no kernel."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import TINY, N_VOCAB, seeded_tree
from gradtts_tpu.config import get_config as jax_get_config
from gradtts_tpu.models import GradTTS as JaxGradTTS
from gradtts_tpu_torch.cli.inference import main as inference_main
from gradtts_tpu_torch.cli.nbest import main as nbest_main
from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.tts import GradTTS, compute_loss, synthesize
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.ops import conv3x3 as tc3
from gradtts_tpu_torch.ops import groupnorm_mish as tgn
from gradtts_tpu_torch.ops import linear_attention as tla
from gradtts_tpu_torch.ops import mas as tmas
from gradtts_tpu_torch.utils.convert import flax_params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, importlib, importlib.abc, sys

class Absent(importlib.abc.MetaPathFinder):
    # the GPU machine lacks the orbax reader's tensorstore, the plots'
    # matplotlib, tqdm, the WORLD/SPTK libraries and speechbrain: here
    # they cannot be imported either
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ABSENT:
            raise ImportError(f'{name} is absent')

ABSENT = ('tensorstore', 'matplotlib', 'tqdm', 'pyworld', 'pysptk',
          'speechbrain')

sys.meta_path.insert(0, Absent())
import gradtts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gradtts_tpu_torch.__path__,
                                               'gradtts_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gradtts_tpu',
                                    *ABSENT))
print(len(names), 'modules;', 'forbidden:', bad)
assert not bad
for needed in ('likelihood.ode', 'likelihood.sde', 'nbest.scoring',
               'nbest.sweep', 'cli.nbest', 'models.hifigan',
               'data.dataset', 'utils.convert', 'utils.io', 'utils.plotting',
               'cli.generate', 'cli.inference_zero', 'cli.playground',
               'eval', 'eval.dsp', 'eval.dtw', 'eval.f0', 'eval.mcep',
               'eval.metrics', 'eval.worldnp', 'eval.world', 'eval.mcd_tool',
               'cli.evaluate', 'cli.evaluate_mcd', 'cli.prepare', 'data.sph',
               'data.corpus', 'utils.profiling', 'parallel',
               'parallel.mesh'):
    assert 'gradtts_tpu_torch.' + needed in names, needed
assert len(names) >= 57
# the WORLD backend runs without pyworld and pysptk: the numpy one
from gradtts_tpu_torch.eval import evaluate_pair, world_available
import numpy as np
assert not world_available()
t = np.arange(8000) / 16000
x = 0.3 * np.sin(2 * np.pi * 200 * t)
assert evaluate_pair(x, x, 16000, backend='world')['mcd'] == 0.0
"""


def test_imports_neither_jax_nor_the_jax_package():
    """Nor tensorstore, matplotlib, tqdm, pyworld, pysptk or speechbrain,
    which the GPU machine lacks: every module, every CLI and the eval
    package included, imports without them, and the WORLD metrics run on
    their numpy implementations."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_point_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    texts = tmp_path / 't.txt'
    texts.write_text('hello\n')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference_main(['-f', str(texts), '-c', 'unused.pt',
                        '-o', str(tmp_path / 'o')])


@pytest.mark.parametrize('cli', ['generate', 'inference_zero',
                                 'playground', 'evaluate'])
def test_new_entry_points_without_gpu_raise(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    emb = tmp_path / 'vec.npy'
    np.save(emb, np.zeros(192, np.float32))
    argv = {'generate': ['-o', str(tmp_path / 'o'), '-c', 'unused.pt'],
            'inference_zero': ['-f', 'unused.txt', '-c', 'unused.pt',
                               '--spk-emb', str(emb)],
            'playground': ['--checkpoint', 'unused.pt', '--filelist',
                           'unused.txt'],
            'evaluate': ['--checkpoint', 'unused.pt', '--vocoder',
                         'unused.pt']}[cli]
    main = importlib.import_module(f'gradtts_tpu_torch.cli.{cli}').main
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(argv)


def test_nbest_score_without_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        nbest_main(['score', '--n-best', 'unused.pkl', '--checkpoint',
                    'unused.pt', '--filelist', 'unused.txt', '--out-dir',
                    str(tmp_path / 'o'), '--preset', 'ljspeech'])


# tedlium-spk is the default preset of cli.nbest score, as in the JAX CLI
@pytest.mark.parametrize('preset,overrides', [
    ('libri-tts', {}), ('tedlium', {}), ('ljspeech', {'encoder_speaker': True}),
    ('tedlium-spk', {})])
def test_speaker_presets_build_and_load_jax_weights(preset, overrides):
    """Each speaker preset at full width: the port's model takes the JAX
    package's parameter tree of the same preset (seeded, every leaf)
    strictly, shape for shape."""
    jcfg = jax_get_config(preset, **overrides)
    jmodel = JaxGradTTS.from_config(jcfg)
    spk = (jnp.zeros((1,), jnp.int32) if jcfg.n_spks > 1
           else jnp.zeros((1, jcfg.spk_emb_dim)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32), jnp.array([8]),
                            jnp.zeros((1, 16, 80)), jnp.array([16]), spk)
    sd = flax_params_to_state_dict(seeded_tree(shapes, 0))
    cfg = get_config(preset, **overrides)
    model = GradTTS.from_config(cfg)
    model.load_state_dict(sd, strict=True)
    assert model.n_spks == cfg.n_spks
    # the speaker concat widens the encoder where there is a speaker table
    assert (model.encoder.proj_m.weight.shape[1] > 192) == (
        cfg.encoder_speaker and cfg.n_spks > 1)
    assert hasattr(model, 'spk_emb') == (cfg.n_spks > 1)


def test_cpu_path_launches_no_kernel():
    torch.manual_seed(0)
    model = GradTTS(n_vocab=N_VOCAB, **TINY).eval()
    for m in model.modules():                # non-zero gains: attention runs
        if hasattr(m, 'g'):
            m.g.data.fill_(0.5)
    counters = (tgn.groupnorm_mish, tla.attention_stats, tla.attention_apply,
                tla.attention_bwd_sweep1, tla.attention_bwd_sweep2,
                tla.attention_jvp_stats, tla.attention_jvp_apply,
                tmas.maximum_path, tc3.conv3x3)
    before = [c.launches for c in counters]
    res = synthesize(model, torch.randint(1, N_VOCAB, (1, 8)),
                     torch.tensor([8]), n_timesteps=2, y_max_length=32)
    assert torch.isfinite(res.decoder_outputs).all()
    # and a training loss with its backward (MAS, K4, K5 on the CPU)
    loss = compute_loss(model, torch.randint(1, N_VOCAB, (2, 8)),
                        torch.tensor([8, 5]), torch.randn(2, 32, 80),
                        torch.tensor([32, 20]))
    (loss.dur_loss + loss.prior_loss + loss.diff_loss).backward()
    # and a likelihood score (MAS, the forward-mode rules: K6, K7)
    res = score_batch(model, torch.randint(1, N_VOCAB, (2, 8)),
                      torch.tensor([8, 5]), torch.randn(2, 32, 80),
                      torch.tensor([32, 20]), n_euler=2,
                      generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(res.score).all()
    assert [c.launches for c in counters] == before
