"""Inputs shared by the tests of varden_tpu_torch: made with numpy from a
seed, so that both packages (and the card) see the same numbers."""
import numpy as np
import pytest
import torch


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


def state_arrays(states):
    """Per-patch dicts of numpy arrays (u, s, gp, p) of a list of States of
    either package."""
    return [{k: np.array(getattr(st, k)) for k in ("u", "s", "gp", "p")}
            for st in states]


def two_blob_rho(n, dx, centers, radius=0.08):
    """A density of 1 plus tanh blobs of height 1 at ``centers`` on a grid
    of n cells of width dx (any dimension)."""
    X = np.meshgrid(*[(np.arange(n[d]) + 0.5) * dx[d] for d in range(len(n))],
                    indexing="ij")
    rho = np.ones(n)
    for c in centers:
        r = np.sqrt(sum((X[d] - c[d]) ** 2 for d in range(len(n))))
        rho += 0.5 * (1.0 - np.tanh((r - radius) / 0.02))
    return rho


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's plain-path tensors on one thread: at the tests' small
    sizes a thread pool only contends with the other test processes.
    Imported by the modules that use it; the pool size is restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
