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


def force_padded_route(monkeypatch):
    """Make varden_tpu take its accelerator route to the padded sweep
    (pallas_kernels.gsrb_sweep_3d, run in interpret mode) on the levels
    where it takes it on the TPU: 3-D, face-tensor beta, x periodic (where
    gsrb_var_sweep_3d refuses), every extent even and >= 8 (gsrb_supported
    without its VMEM clause). Returns a list that counts the sweeps."""
    import functools
    from varden_tpu.bc import BC_PER
    from varden_tpu.ops import pallas_kernels as pk
    calls = []
    sweep = functools.partial(pk.gsrb_sweep_3d, interpret=True)

    def supported(level):
        return (level.dm == 3
                and all(getattr(b, "ndim", 0) > 0 for b in level.beta)
                and BC_PER in level.ell_bc[0]
                and all(s >= 8 and s % 2 == 0 for s in level.n))

    def counted(*a, **k):
        calls.append(1)
        return sweep(*a, **k)

    monkeypatch.setattr(pk, "gsrb_supported", supported)
    monkeypatch.setattr(pk, "gsrb_sweep_3d", counted)
    return calls


def run_inputs_both(path, **over):
    """Run an inputs file through both packages on the CPU in float64 with
    the given overrides (no plotfiles, no checkpoints, quiet): returns
    (varden_tpu driver, port driver, varden_tpu states, port states), the
    states as a list of patches."""
    from varden_tpu.config import load_config as jload
    from varden_tpu.driver import Varden as JVarden
    from varden_tpu_torch.config import load_config as tload
    from varden_tpu_torch.driver import Varden as TVarden
    over = dict(dict(dtype="float64", plot_int=-1, chk_int=-1, verbose=0),
                **over)
    jv, tv = JVarden(jload(path, **over)), TVarden(tload(path, **over),
                                                   device="cpu")
    js, ts = jv.run(), tv.run()
    if not isinstance(js, (list, tuple)):
        js, ts = [js], [ts]
    return jv, tv, list(js), list(ts)


def assert_runs_agree(jv, tv, js, ts, tol=1e-9):
    """Both runs took the same steps, times and (multi-level) boxes, and
    every field of every patch agrees to ``tol`` of the field's size."""
    assert tv.istep == jv.istep
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    if getattr(jv, "geom", None) is not None and len(js) > 1:
        assert [(tuple(s.lo), tuple(s.n)) for s in tv.geom.specs] == \
            [(tuple(s.lo), tuple(s.n)) for s in jv.geom.specs]
        assert list(tv.geom.parent) == list(jv.geom.parent)
    assert len(ts) == len(js)
    for a, b in zip(state_arrays(ts), state_arrays(js)):
        for k in a:
            assert np.isfinite(a[k]).all(), k
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= tol * scale, k
