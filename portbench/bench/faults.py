"""Faults planted in the program under the relocalization driver, for the
check that `correct` comes out false when the timed path is broken:

  answer     one pair's rotation comes back transposed where the
             registration produces it
  match      two instances of scene 0 trade partners where the matcher
             produces them
  unchanged  ICP returns the pose it started from
  half       the registration runs on the first half of the pairs only and
             hands its answers out again for the second half
"""
from __future__ import annotations

import contextlib

import torch

PIPELINE = "livingscenes_tpu_torch.solver.pipeline"
REGISTRATION = "livingscenes_tpu_torch.solver.registration"


def _answer(real):
    def registration(*a, **k):
        R, t = real(*a, **k)
        R = R.clone()
        R[0] = R[0].transpose(0, 1).clone()
        return R, t
    return registration


def _match(real):
    def matcher(*a, **k):
        out = real(*a, **k)
        m = out["matches0"].clone()
        m[0, [0, 1]] = m[0, [1, 0]]
        return dict(out, matches0=m)
    return matcher


def _unchanged(real):
    def icp(*a, **k):
        return real(*a, **dict(k, max_iterations=0))
    return icp


def _half(real):
    def registration(model, pc1, pc2, codes1=None, codes2=None, **k):
        h = pc1.shape[0] // 2
        R, t = real(model, pc1[:h], pc2[:h], {n: v[:h] for n, v in codes1.items()},
                    {n: v[:h] for n, v in codes2.items()}, **k)
        return torch.cat([R, R]), torch.cat([t, t])
    return registration


FAULTS = {"answer": (PIPELINE, "solve_pairwise_registration", _answer),
          "match": (PIPELINE, "sequential_matcher", _match),
          "unchanged": (REGISTRATION, "iterative_closest_point", _unchanged),
          "half": (PIPELINE, "solve_pairwise_registration", _half)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place, restored on exit."""
    import importlib

    module, attr, make = FAULTS[name]
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)
