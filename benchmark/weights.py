"""Seeded weights, drawn on the device in two calls.

The scheme is ``chip_smoke.py``'s ``seeded_state_dict``: every ReZero gain
uniform in [0.3, 0.7]; every vector (bias, norm scale or shift) N(0, 0.3);
every other tensor N(0, 1) * gain / sqrt(fan_in), fan_in the product of
its dimensions after the first. The gains keep a random score U-Net's
residual stream finite through the Euler steps (a random score does not
pull x_t back to mu, and the linear attention is quadratic in its input's
scale).

The text encoder's vectors are drawn as a trained encoder's are shaped:
LayerNorm scales 1 + N(0, 0.1), shifts N(0, 0.1), biases N(0, 0.02).
With N(0, 0.3) there, the constant parts of the biases and shifts swamp
every token's own part within six layers, and every token comes out the
same. The duration predictor's output conv is drawn at a twentieth of the
gain, so that its bias, which the configuration fixes (``fixed``), sets
every token's frames whatever the seed. A traffic may scale the score
U-Net's output conv (``score_output_gain``, applied by the drive): a random
U-Net's Jacobian is far smaller than a trained score's, whose divergence
is of the order of the drift's linear term.
"""

import math

import torch

GAINS = (('to_qkv', 0.05), ('res_conv', 0.3), ('.3.conv', 0.5),
         ('proj_w.proj', 0.05))


def seeded_state_dict(shapes, seed, device, fixed=None):
    """{name: shape} -> {name: f32 tensor on ``device``}, drawn from
    ``seed`` with one normal and one uniform draw."""
    fixed = fixed or {}
    gains = [n for n in shapes if n.endswith('.g')]
    drawn = [n for n in shapes if n not in fixed and n not in gains]
    total = sum(math.prod(shapes[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(len(gains), generator=gen, device=device)
    out, at = {}, 0
    for name in drawn:
        shape = tuple(shapes[name])
        n = math.prod(shape)
        if len(shape) == 1:
            scale = vector_scale(name)
        else:
            gain = next((g for key, g in GAINS if key in name), 1.0)
            scale = gain / math.sqrt(math.prod(shape[1:]))
        out[name] = normal[at:at + n].view(shape) * scale
        if name.startswith('encoder.') and name.endswith('.gamma'):
            out[name] += 1.0
        at += n
    for i, name in enumerate(gains):
        out[name] = (0.3 + 0.4 * uniform[i]).reshape(shapes[name])
    for name, value in fixed.items():
        out[name] = torch.full(tuple(shapes[name]), float(value),
                               device=device)
    return out


def vector_scale(name):
    """The standard deviation of a vector's draw."""
    if not name.startswith('encoder.'):
        return 0.3
    return 0.1 if name.endswith(('.gamma', '.beta')) else 0.02


def shapes_of(module):
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}
