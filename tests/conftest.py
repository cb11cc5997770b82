"""Suite-wide fixtures.

The fused-program disk cache (``core.exprops``) defaults to
``~/.cache/repro/exprops``; tests must neither litter the user's real
cache nor read stale programs from it (which would couple test outcomes
to machine state), so the whole session is pointed at a throwaway
directory.  Individual tests that probe the cache behavior override the
variable themselves via ``monkeypatch``.

``make_drift_stream`` is the fault-injection helper for the online
calibration suite: synthetic timing streams from a known ground-truth
linear model with a hardware-drift step (a multiplicative slowdown)
injected mid-stream.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest


@pytest.fixture(scope="session", autouse=True)
def _isolated_compile_cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exprops-cache"))
    old = os.environ.get("REPRO_COMPILE_CACHE")
    os.environ["REPRO_COMPILE_CACHE"] = d
    yield
    if old is None:
        os.environ.pop("REPRO_COMPILE_CACHE", None)
    else:
        os.environ["REPRO_COMPILE_CACHE"] = old


#: real taxonomy keys + ground-truth seconds/event weights (v5e-seed scale)
#: used by the drift streams, so refit models are directly usable by the
#: prediction paths (plan_property_vector emits keys from this family)
DRIFT_KEYS = ["mxu:16", "load:32:s1", "store:32:s1", "flop:32:add",
              "coll:all_reduce", "const1"]
DRIFT_WEIGHTS = np.array([2.5e-15, 9.0e-12, 9.5e-12, 1.6e-13,
                          1.2e-11, 5.0e-6])


@pytest.fixture
def make_drift_stream():
    """Factory for synthetic timing streams with an injected drift step.

    Returns (pvs, times, ...) where ``times[j] = <w_true, p_j>`` for
    ``j < n_pre`` and ``shift × <w_true, p_j>`` after — the "device got
    1.5× slower mid-run" scenario — with optional multiplicative
    lognormal-ish noise.  Property vectors vary randomly per sample (full
    column rank), so batch/RLS fits are identifiable.
    """
    def _make(n_pre=120, n_post=80, shift=1.5, noise=0.0, seed=0,
              keys=None, weights=None):
        keys = list(keys) if keys is not None else list(DRIFT_KEYS)
        w = (np.asarray(weights, dtype=np.float64) if weights is not None
             else DRIFT_WEIGHTS[:len(keys)].copy())
        rng = np.random.default_rng(seed)
        pvs, times = [], []
        for j in range(n_pre + n_post):
            counts = rng.uniform(0.5, 2.0, size=len(keys)) * 1e9
            pv = {k: float(c) for k, c in zip(keys, counts)}
            if "const1" in pv:
                pv["const1"] = 1.0
            t = float(sum(w[i] * pv[k] for i, k in enumerate(keys)))
            if j >= n_pre:
                t *= shift
            if noise:
                t *= float(np.exp(noise * rng.standard_normal()))
            pvs.append(pv)
            times.append(t)
        return SimpleNamespace(pvs=pvs, times=times, keys=keys,
                               weights=w, shift_index=n_pre, shift=shift)
    return _make


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU with nvcc (CUDA kernels have no interpret "
        "mode); skipped where there is none")
