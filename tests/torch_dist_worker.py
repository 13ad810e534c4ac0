"""One rank of a data- or tensor-parallel run of gradtts_tpu_torch over
gloo on the CPU, started as torchrun starts a process (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment);
the worker of tests/test_torch_distributed.py. It imports no JAX:

    python tests/torch_dist_worker.py SCENARIO SPEC.json

- ``steps``: one train step of a ``DistributedDataParallel`` model over
  the ranks, for each set-up of SPEC: the tiny model with the given
  weights, dropout off and the given draws; the same with dropout on and
  the draws from a seeded generator; each preset (seeded weights) and one
  with remat. Writes each rank's metrics, parameters, clipped gradients
  and the names of the parameters that got no grad to
  ``{out}/{name}_{rank}.pt``; with ``score`` in SPEC then ``score_batch``
  of the given weights on the mesh, each of its runs on this rank's rows
  of its batch, to ``{out}/score_{rank}.pt``.
- ``train_cli``: ``cli.train.main`` with SPEC's argv, then again with one
  more step (a resume); writes each run's step and metrics and the final
  parameters to ``{out}/train_cli_{rank}.pt``.
- ``generate``: ``cli.generate.main`` with SPEC's argv.
- ``tp_steps``: tensor parallelism on a (data, model) mesh of SPEC's
  shape: the ``steps`` of the given weights (dropout off with the given
  draws, then on) with the model split over 'model'
  (``shard_model``) and DDP over 'data', each rank's parameters and
  gradients its blocks, and the ``score`` runs with the model split; with
  ``functions`` in SPEC first the values, gradients and forward-mode
  tangents of ``copy_to_model``, ``gather_from_model`` and
  ``scatter_to_model`` on seeded inputs, to ``{out}/functions_{rank}.pt``.
- ``cli_runs``: ``cli.train.main`` with each argv of SPEC's ``runs``.
"""

import json
import os
import sys

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from gradtts_tpu_torch.config import get_config
from gradtts_tpu_torch.models.layers import RowShard
from gradtts_tpu_torch.models.tts import GradTTS
from gradtts_tpu_torch.nbest.scoring import score_batch
from gradtts_tpu_torch.parallel.mesh import (AXES, batch_sharding,
                                             initialize_distributed,
                                             make_mesh, shard_batch,
                                             shard_model, world)
from gradtts_tpu_torch.parallel.tensor import (ModelSplit, copy_to_model,
                                               gather_from_model,
                                               scatter_to_model)
from gradtts_tpu_torch.train.loop import batch_to
from gradtts_tpu_torch.train.state import make_optimizer, train_step


def _step(name, model, spec, mesh, batch, generator=None, draws=None,
          remat=False):
    ddp = DistributedDataParallel(model, process_group=mesh.get_group('data'))
    optimizer = make_optimizer(model.parameters())
    metrics = train_step(ddp, optimizer, batch, spec['out_size'], 1.0,
                         generator, remat, draws)
    missing = [n for n, p in model.named_parameters()
               if p.requires_grad and p.grad is None]
    torch.save({'metrics': {k: float(v) for k, v in metrics.items()},
                'params': model.state_dict(), 'missing': missing,
                'grads': {n: p.grad for n, p in model.named_parameters()
                          if p.grad is not None},
                'coord': [mesh.get_local_rank(a) for a in AXES]},
               os.path.join(spec['out'], f'{name}_{world()[0]}.pt'))


def steps(spec, mesh=None):
    mesh = mesh or make_mesh(device_type='cpu')
    rows = batch_sharding(mesh)
    glob = dict(np.load(spec['batch']))
    batch = batch_to(shard_batch(mesh, glob), 'cpu')
    n_vocab = get_config('ljspeech').n_vocab
    sd = torch.load(spec['state_dict'], weights_only=True)
    for name, train in (('jax', False), ('dropout', True)):
        model = GradTTS(n_vocab=n_vocab, **spec['hp'])
        model.load_state_dict(sd, strict=True)
        model.train(train)
        shard_model(model, mesh)
        if train:
            _step(name, model, spec, mesh, batch,
                  torch.Generator().manual_seed(spec['seed']))
        else:
            draws = {k: torch.from_numpy(rows(v)) for k, v in
                     np.load(spec['draws']).items()}
            draws['offset'] = draws['offset'].long()
            _step(name, model, spec, mesh, batch, draws=draws)
    for name, preset, overrides, remat in spec.get('setups', ()):
        cfg = get_config(preset, **overrides)
        torch.manual_seed(0)
        model = GradTTS.from_config(cfg).train()
        rng = np.random.default_rng(1)
        b = len(glob['x_lengths'])
        setup = dict(glob)
        if cfg.n_spks > 1:
            setup['spk'] = rng.integers(0, cfg.n_spks, b)
        elif cfg.n_spks == -1:
            setup['spk'] = rng.standard_normal(
                (b, cfg.spk_emb_dim)).astype(np.float32)
        _step(name, model, spec, mesh,
              batch_to(shard_batch(mesh, setup), 'cpu'),
              torch.Generator().manual_seed(spec['seed']), remat=remat)
    if 'score' in spec:
        score(spec, mesh)


def score(spec, mesh):
    """``score_batch`` of SPEC's weights, split over the mesh's 'model'
    axis, on this rank's rows of ``score['batch']``: each run of
    ``score['runs']`` with its keywords, its probe the rows of the one in
    the file ``probe`` or drawn from a generator seeded ``seed``
    (``RowShard``)."""
    sc = spec['score']
    rows = batch_sharding(mesh)
    batch = batch_to(shard_batch(mesh, dict(np.load(sc['batch']))), 'cpu')
    model = GradTTS(n_vocab=get_config('ljspeech').n_vocab, **spec['hp'])
    model.load_state_dict(torch.load(spec['state_dict'], weights_only=True),
                          strict=True)
    shard_model(model.eval(), mesh)
    out = {'coord': [mesh.get_local_rank(a) for a in AXES]}
    for name, kw in sc['runs'].items():
        kw = dict(kw)
        if 'probe' in kw:
            kw['epsilon'] = torch.from_numpy(rows(np.load(kw.pop('probe'))))
        else:
            kw['generator'] = RowShard(
                torch.Generator().manual_seed(kw.pop('seed')),
                mesh.get_local_rank('data'), mesh.size(0))
        res = score_batch(model, batch['x'], batch['x_lengths'], batch['y'],
                          batch['y_lengths'], mesh=mesh, **kw)
        out[name] = res._asdict()
    torch.save(out, os.path.join(spec['out'], f'score_{world()[0]}.pt'))


def train_cli(spec):
    from gradtts_tpu_torch.cli.train import main
    runs = []
    for extra in (['--max-steps', '2'], ['--max-steps', '1']):
        res = main(spec['argv'] + extra)
        runs.append({'step': res.step, 'metrics': res.metrics})
    torch.save({'runs': runs, 'params': res.model.state_dict()},
               os.path.join(spec['out'], f'train_cli_{world()[0]}.pt'))


def generate(spec):
    from gradtts_tpu_torch.cli.generate import main
    main(spec['argv'])


def functions(spec, mesh):
    """The three Functions on the 'model' axis, on inputs drawn from one
    seed (the same on every rank): each output and the gradient of its
    input under a rank-dependent upstream gradient; then each output's
    tangent by ``torch.func.jvp`` along a seeded tangent of the whole
    input (this rank's block of it where the input is a block), and a
    gather whose input carries none inside a jvp."""
    split = ModelSplit(mesh.get_group('model'), mesh.get_local_rank('model'),
                       mesh.size(1), 0)
    j = split.index
    rng = np.random.default_rng(spec['seed'])
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 5), np.float32))
    ups = torch.from_numpy(rng.standard_normal((split.size, 2, 8, 3, 5),
                                               np.float32))
    dx = torch.from_numpy(rng.standard_normal((2, 8, 3, 5), np.float32))

    def own(t):
        return t[:, 4 * j:4 * j + 4].contiguous(
            memory_format=torch.channels_last)

    out = {}
    for name, fn, given, upstream, tangent in (
            ('copy', lambda t: copy_to_model(t, split), x, ups[j], dx),
            ('gather', lambda t: gather_from_model(t, split, 1), own(x),
             ups[0], own(dx)),
            ('scatter', lambda t: scatter_to_model(t, split, 1), x,
             ups[j][:, 4 * j:4 * j + 4], dx)):
        t = given.clone().requires_grad_()
        y = fn(t)
        y.backward(upstream)
        with torch.no_grad():
            _, dy = torch.func.jvp(fn, (given,), (tangent,))
        out[name] = {'value': y.detach(), 'grad': t.grad, 'tangent': dy}
    with torch.no_grad():
        out['gather_no_tangent'] = dict(zip(('value', 'tangent'),
                                            torch.func.jvp(
            lambda t: t * gather_from_model(own(x), split, 1), (x,), (dx,))))
    torch.save(out, os.path.join(spec['out'], f'functions_{world()[0]}.pt'))


def tp_steps(spec):
    mesh = make_mesh(spec['data'], spec['model'], device_type='cpu')
    if spec.get('functions'):
        functions(spec, mesh)
    steps(spec, mesh)


def cli_runs(spec):
    from gradtts_tpu_torch.cli.train import main
    for argv in spec['runs']:
        main(argv)


def run(scenario, spec_path):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    if scenario in ('steps', 'tp_steps'):
        # the CLIs join the process group themselves
        initialize_distributed(device='cpu')
    {'steps': steps, 'train_cli': train_cli, 'generate': generate,
     'tp_steps': tp_steps, 'cli_runs': cli_runs}[scenario](spec)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    run(*sys.argv[1:])
