"""The numbers that decide ``correct``: each a gap between what the
program's timed path produced and what the plain reference works out
from the same inputs. Each is 0 for an exact match and grows with the
gap; each cell's limits are in ``limits/<workload>.json``."""

import math

import torch


def rel_max(got, want, mask=None):
    """max |got - want| over ``mask`` (where given) / max |want| there."""
    got, want = got.double(), want.double()
    if mask is not None:
        mask = mask.bool().expand_as(want)
        got, want = got[mask], want[mask]
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def gap_over(got, want, part):
    """max |got - want| / max |part|: a gap against the part of ``want``
    that the comparison is about."""
    gap = (got.double() - want.double()).abs().max()
    return float(gap / part.double().abs().max().clamp_min(1e-30))


def duration_gap(attn, w_ref, x_lengths, budget):
    """The relative change of the reference's duration w that the
    program's integer durations (the frames of each token's row of
    ``attn`` [B, Tx, Ty]) would need: 0 where ceil(w_ref) is the program's
    duration d, else the distance from w_ref to (d - 1, d] over w_ref.
    Tokens whose frames reach the frame budget are left out, as the clamp
    to the budget cuts their duration."""
    d = attn.sum(-1).double()                                # [B, Tx]
    end = torch.cumsum(d, 1)
    w = w_ref.double()
    tokens = torch.arange(d.shape[1], device=d.device)[None] \
        < x_lengths[:, None]
    inside = tokens & (end < budget)
    below = (d - 1 - w).clamp_min(0)
    above = (w - d).clamp_min(0)
    gap = torch.maximum(below, above) / w.clamp_min(1e-30)
    return float(gap[inside].max()) if inside.any() else 0.0


def rel_range(got, want):
    """max over rows of |got - want| of [B] values, over the range of
    ``want``: a gap against the differences that rank the rows."""
    got, want = got.double(), want.double()
    spread = (want.max() - want.min()).clamp_min(1e-30)
    return float((got - want).abs().max() / spread)


def leaf_gaps(got, want, keep):
    """Each leaf's |‖got‖ - ‖want‖| over max(‖want‖, the median leaf's
    ‖want‖), over the leaves named in ``keep``, sorted."""
    norms = {n: (float(got[n].double().norm()), float(want[n].double().norm()))
             for n in keep}
    med = float(torch.tensor([w for _, w in norms.values()]).median())
    return sorted(abs(g - w) / max(w, med, 1e-30) for g, w in norms.values())


def median(values):
    return float(torch.tensor(values, dtype=torch.float64).median())


def moving_leaves(grads):
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's: the others (such as a key's bias under softmax) move
    under Adam by round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def loss_gap(got, want):
    """max over steps and loss terms of |got - want| / |want|."""
    return max(abs(g - w) / max(abs(w), 1e-30)
               for gs, ws in zip(got, want) for g, w in zip(gs, ws))


def event_part(logp, event_size):
    """-(log p + n/2 log 2 pi) in float64: the part of a standard normal
    log density that depends on the point (half its squared distance)."""
    return -(logp.double() + event_size / 2.0 * math.log(2 * math.pi))
