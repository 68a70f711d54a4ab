"""The port's tuning cache of measured program costs
(``ml_recipe_tpu_torch/ops/autotune.py``) against the JAX package's cost
plane (``ml_recipe_tpu/ops/autotune.py``: ``record_cost``, ``lookup_cost``,
the per-device-kind JSON file, the toolchain key, corrupt-cache recovery,
``MLRT_AUTOTUNE`` and ``session_summary``)."""

import json
import logging

import pytest

from ml_recipe_tpu.ops import autotune as jtune
from ml_recipe_tpu_torch.ops import autotune

KEY = "serve-step-8x128-h768l12n12v30522-ids"
COST = {"est_seconds": 0.0031, "source": "measured", "dispatch": "graph"}


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_device_kind", lambda: "FakeGPU H0")
    monkeypatch.setattr(autotune, "_toolchain",
                        lambda: "torch-2.x+cuda-12.x+nvcc-12.x")
    monkeypatch.delenv(autotune.ENV_ENABLED, raising=False)
    t = autotune.reset()
    t.enabled = True
    t.set_cache_dir(tmp_path / "tuning")
    yield t
    autotune.reset()


def _fresh(tuner):
    return autotune.CostTuner(cache_dir=tuner.cache_dir, enabled=True)


def test_round_trip_and_warm_restart_measures_nothing(tuner):
    assert tuner.lookup_cost(KEY) is None
    tuner.record_cost(KEY, COST)
    assert tuner.lookup_cost(KEY) == COST
    summary = tuner.session_summary()
    assert (summary["cache"], summary["probes"]) == ("miss", 1)
    path = tuner.cache_dir / "FakeGPU_H0.torch.json"
    raw = json.loads(path.read_text())
    assert raw["toolchain"] == "torch-2.x+cuda-12.x+nvcc-12.x"
    assert raw["entries"][KEY]["cost_estimates"]["program"] == COST
    warm = _fresh(tuner)
    assert warm.lookup_cost(KEY) == COST
    assert warm.session_summary()["cache"] == "hit"
    assert warm.session_summary()["probes"] == 0


def test_the_same_calls_on_both_packages(tuner, monkeypatch):
    """record/lookup round trips of the same keys and costs, and the
    summary's keys, on both packages' caches."""
    monkeypatch.setattr(jtune, "_device_kind", lambda: "FakeGPU H0")
    jt = jtune.GeometryAutotuner(cache_dir=tuner.cache_dir, enabled=True)
    assert set(tuner.session_summary()) == set(jt.session_summary())
    for key, est in ((KEY, COST), ("serve-step-32x384-x", {
            "est_seconds": None})):
        jt.record_cost(key, est)
        tuner.record_cost(key, est)
        assert tuner.lookup_cost(key) == jt.lookup_cost(key) == est
    assert tuner.lookup_cost("absent") is jt.lookup_cost("absent") is None
    # one directory, two files: neither package reads or rewrites the
    # other's
    names = sorted(p.name for p in tuner.cache_dir.iterdir())
    assert names == ["FakeGPU_H0.json", "FakeGPU_H0.torch.json"]
    assert _fresh(tuner).lookup_cost(KEY) == COST


@pytest.mark.parametrize("garbage", [b"{not json", b"[1, 2]", b"",
                                     b'{"version": 1, "toolchain": '
                                     b'"torch-2.x+cuda-12.x+nvcc-12.x", '
                                     b'"entries": 7}'])
def test_corrupt_cache_recovers(tuner, caplog, garbage):
    path = tuner.cache_dir / "FakeGPU_H0.torch.json"
    path.parent.mkdir(parents=True)
    path.write_bytes(garbage)
    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        assert tuner.lookup_cost(KEY) is None
    assert "corrupt tuning cache" in caplog.text
    tuner.record_cost(KEY, COST)              # rewrites the file whole
    assert _fresh(tuner).lookup_cost(KEY) == COST


def test_toolchain_change_drops_the_cache(tuner, monkeypatch, caplog):
    tuner.record_cost(KEY, COST)
    monkeypatch.setattr(autotune, "_toolchain",
                        lambda: "torch-9.x+cuda-13.x+nvcc-13.x")
    warm = _fresh(tuner)
    with caplog.at_level(logging.WARNING, logger=autotune.__name__):
        assert warm.lookup_cost(KEY) is None
    assert "written by toolchain" in caplog.text
    warm.record_cost(KEY, {"est_seconds": 0.5, "source": "measured"})
    raw = json.loads((tuner.cache_dir / "FakeGPU_H0.torch.json").read_text())
    assert raw["toolchain"] == "torch-9.x+cuda-13.x+nvcc-13.x"
    assert list(raw["entries"]) == [KEY]


def test_device_kinds_keep_their_own_costs(tuner, monkeypatch):
    tuner.record_cost(KEY, COST)
    monkeypatch.setattr(autotune, "_device_kind", lambda: "OtherGPU B9")
    other = _fresh(tuner)
    assert other.lookup_cost(KEY) is None
    other.record_cost(KEY, {"est_seconds": 9.0, "source": "measured"})
    monkeypatch.setattr(autotune, "_device_kind", lambda: "FakeGPU H0")
    assert _fresh(tuner).lookup_cost(KEY) == COST


def test_disabled_tuner_records_and_reads_nothing(tuner, monkeypatch):
    tuner.enabled = False
    tuner.record_cost(KEY, COST)
    assert tuner.lookup_cost(KEY) is None
    assert not tuner.cache_dir.exists()
    assert tuner.session_summary()["cache"] == "disabled"
    monkeypatch.setenv(autotune.ENV_ENABLED, "off")
    monkeypatch.setenv(jtune.ENV_ENABLED, "off")
    assert autotune.reset().enabled is False
    assert jtune.reset().enabled is False
    monkeypatch.delenv(autotune.ENV_ENABLED)       # the same variable
    assert autotune.reset().enabled is True
    assert jtune.reset().enabled is True


def test_configure_and_default_directory(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.ENV_CACHE_DIR, str(tmp_path / "env"))
    assert autotune.reset().cache_dir == tmp_path / "env"
    monkeypatch.delenv(autotune.ENV_CACHE_DIR)
    default = autotune.reset().cache_dir
    assert default.parts[-2:] == ("artifacts", "tuning")
    assert default == jtune.default_cache_dir()     # the same variable
    t = autotune.configure(enabled=False, cache_dir=tmp_path / "flag")
    assert (t.enabled, t.cache_dir) == (False, tmp_path / "flag")
    autotune.reset()
