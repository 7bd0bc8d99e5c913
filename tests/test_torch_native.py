"""The port's native sensor runtime (cerberus_tpu_torch/native.py, built from
native/sensor_sync.cpp with g++ into build/) against the JAX package's
binding of the same source and against the Python PySensorSync, on
tests/test_native.py's cases; and the estimator's use_native switch.

Tolerances: none — every extract is compared exactly (np.array_equal: the
same C++ code, and PySensorSync does the same float64 operations in the
same order), and CsvWriter output byte for byte.
"""

import filecmp

import numpy as np
import pytest

from cerberus_tpu import native as jnative
from cerberus_tpu.estimator.estimator import PySensorSync as jPySync
from cerberus_tpu_torch import _build
from cerberus_tpu_torch import native
from cerberus_tpu_torch.estimator.estimator import Estimator, PySensorSync


@pytest.fixture(autouse=True)
def _jax_native_lib():
    """The comparisons need the JAX package's binding of the same source
    (decided here, not while the module is imported)."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")


def make_sample(t):
    return (t, np.full(3, t), np.full(3, -t), np.full(12, 2 * t),
            np.full(12, 3 * t), np.array([1.0, 0, 1, 0]))


def _syncs(capacity):
    """The port's native sync, the JAX package's and the two Python ones
    (PySensorSync keeps its own unbounded-by-default capacity)."""
    return {"port": native.SensorSync(capacity),
            "jax": jnative.SensorSync(capacity),
            "py": PySensorSync(), "jax_py": jPySync()}


def _same(outs, label):
    ref = outs["jax"]
    for name, out in outs.items():
        assert (out is None) == (ref is None), (label, name)
        if ref is not None:
            assert np.array_equal(out, ref), (label, name)
    n = "None" if ref is None else str(ref.shape)
    print(f"PORT_DIFF native.SensorSync {label} {n} equal (exact)")


def test_push_extract_with_boundaries():
    syncs = _syncs(1024)
    for k in range(100):
        for s in syncs.values():
            s.push(*make_sample(k * 0.002))
    assert syncs["port"].size() == 100
    assert syncs["port"].latest_time() == syncs["jax"].latest_time()
    out = {n: s.extract(0.0101, 0.0501) for n, s in syncs.items()}
    _same(out, "boundaries")
    np.testing.assert_allclose(out["port"][0, 0], 0.0101, atol=1e-12)
    np.testing.assert_allclose(out["port"][-1, 0], 0.0501, atol=1e-12)
    _same({n: s.extract(0.0501, 0.1001) for n, s in syncs.items()},
          "consecutive")


def test_extract_insufficient_data():
    syncs = _syncs(64)
    for k in range(5):
        for s in syncs.values():
            s.push(*make_sample(k * 0.002))
    _same({n: s.extract(0.0, 1.0) for n, s in syncs.items()}, "not reached")
    assert syncs["port"].extract(0.0, 1.0) is None


def test_ring_overwrite():
    """A 16-slot ring keeps the newest 16 samples, as the JAX package's
    (the Python syncs keep everything, so only the two rings compare)."""
    port, jax_ = native.SensorSync(16), jnative.SensorSync(16)
    for k in range(100):
        port.push(*make_sample(k * 0.002))
        jax_.push(*make_sample(k * 0.002))
    assert port.size() == jax_.size() == 16
    _same({"port": port.extract(0.19, 0.197), "jax": jax_.extract(0.19,
                                                                  0.197)},
          "ring overwrite")
    assert (port.extract(0.197, 0.198)[:, 0] >= 0.168).all()


def test_jittered_stream_matches_every_sync():
    """tests/test_native.py::test_python_sync_matches_native with the port's
    sync beside: 500 jittered samples, interval ends off the sample clock,
    the first extract from -1e18, then not-yet-reached."""
    rng = np.random.default_rng(3)
    syncs = _syncs(4096)
    t = 0.0
    for _ in range(500):
        t += rng.uniform(0.0015, 0.0025)
        row = (t, rng.normal(size=3), rng.normal(size=3), rng.normal(size=12),
               rng.normal(size=12), (rng.random(4) > 0.5).astype(float))
        for s in syncs.values():
            s.push(*row)
    prev = -1e18
    for t1 in np.sort(rng.uniform(0.05, t - 0.05, size=12)):
        _same({n: s.extract(prev, t1) for n, s in syncs.items()},
              f"cut {t1:.4f}")
        prev = t1
    _same({n: s.extract(prev, t + 1.0) for n, s in syncs.items()},
          "past the end")


def test_csv_writer_bytes_equal(tmp_path):
    rows = [[1.0, 2.5, -3.25], [4, 5, 6], [1e-12, 123456789.123, np.pi]]
    for mod, name in ((native, "port.csv"), (jnative, "jax.csv")):
        w = mod.CsvWriter(str(tmp_path / name), "a,b,c")
        for r in rows:
            w.row(r)
        w.close()
    assert filecmp.cmp(tmp_path / "port.csv", tmp_path / "jax.csv",
                       shallow=False)
    lines = (tmp_path / "port.csv").read_text().splitlines()
    assert lines[:2] == ["a,b,c", "1,2.5,-3.25"]


def test_built_from_source_into_build_dir():
    """The port loads its own build of native/sensor_sync.cpp (keyed by the
    source's hash under build/cerberus_tpu_torch/), never the prebuilt
    native/libsensor_sync.so."""
    lib = _build.build_native()
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith(
        "libsensor_sync-")
    assert native.get_lib()._name == str(lib)


def test_estimator_use_native(monkeypatch):
    """use_native keeps the JAX package's meaning (None: native when the
    library builds), except that use_native=True never degrades: a failed
    build raises instead of falling back to PySensorSync."""
    assert isinstance(Estimator(device="cpu").sync, native.SensorSync)
    assert isinstance(Estimator(device="cpu", use_native=False).sync,
                      PySensorSync)

    def broken():
        raise RuntimeError("g++ failed for sensor_sync.cpp")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(_build, "build_native", broken)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.SensorSync()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        Estimator(device="cpu", use_native=True)
    est = Estimator(device="cpu")
    assert not est.use_native and isinstance(est.sync, PySensorSync)


def test_failed_build_is_tried_once(monkeypatch):
    """A failed build is remembered: later estimators (use_native=None) and
    later SensorSync() calls raise the same error without compiling again."""
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("g++ failed for sensor_sync.cpp")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(_build, "build_native", broken)
    for _ in range(3):
        assert isinstance(Estimator(device="cpu").sync, PySensorSync)
        assert not native.available()
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.SensorSync()
    assert len(calls) == 1
