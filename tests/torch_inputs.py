"""Inputs shared by the tests of varden_tpu_torch: made with numpy from a
seed, so that both packages (and the card) see the same numbers."""
import numpy as np


def smooth(shape, seed, amp=0.5, dm=3):
    """A sum of three low sine modes over the last ``dm`` axes, one draw per
    leading index. The multigrid solvers converge on such fields at the rate
    the projections see, where white noise can stall their V-cycles, and a
    Godunov upwind choice on them flips only at roundoff-level ties."""
    rng = np.random.RandomState(seed)
    X = np.meshgrid(*[np.linspace(0.0, 1.0, s) for s in shape[-dm:]],
                    indexing="ij")
    out = np.zeros(shape)
    for idx in np.ndindex(*shape[:-dm]):
        f = np.zeros(shape[-dm:])
        for _ in range(3):
            k, ph = rng.randint(1, 4, size=dm), rng.rand(dm) * 2 * np.pi
            f += np.prod([np.sin(k[d] * np.pi * X[d] + ph[d])
                          for d in range(dm)], axis=0)
        out[idx] = amp * f / 3.0
    return out
