"""The port's store of built kernel libraries (``ml_recipe_tpu_torch/ops/aot.py``)
against the JAX package's program store (``ml_recipe_tpu/ops/aot.py``).

This machine has no ``nvcc``: the builds here are a fake builder (a
function, or a stand-in ``nvcc`` script writing known bytes) and ctypes'
loader is replaced, exactly as the JAX tests inject theirs. The tests count
builds, never time: a store hit is a load with no build.

- round trip: a miss builds and writes, a fresh store over the same
  directory (a restarted process) hits with no build and the same bytes;
- the store off bypasses and writes nothing;
- truncated or mangled artifacts are misses that rebuild, never crashes;
- keys are isolated by device kind and by library;
- a stale salt and a changed toolchain component miss loudly;
- build errors propagate;
- ``parse_bytes``, ``evict_to_budget`` and the ``--list`` / ``--verify`` /
  ``--evict`` tool against the JAX functions on the same inputs;
- ``cuda_build`` builds and loads every library through the store, and
  ``build_counts`` / ``load_events`` keep their meaning.
"""

import hashlib
import json
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

from ml_recipe_tpu.ops import aot as jaot
from ml_recipe_tpu_torch.ops import aot, cuda_build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh process-wide store on a per-test directory, the device kind
    and the toolchain pinned."""
    monkeypatch.setattr(aot, "_device_kind", lambda: "FakeGPU H0")
    monkeypatch.setattr(aot, "_toolchain_versions", lambda: {
        "torch": "2.x", "cuda": "12.x", "nvcc": "12.x, V12.x"})
    monkeypatch.delenv(aot.ENV_SALT, raising=False)
    st = aot.reset()
    st.enabled = True
    st.set_cache_dir(tmp_path / "aot")
    yield st
    aot.reset()


def _fresh(store):
    """A second store over the same directory: the restarted process."""
    return aot.ProgramCache(cache_dir=store.cache_dir, enabled=True)


class Builder:
    """A fake ``nvcc``: returns ``blob`` and counts its runs."""

    def __init__(self, blob=b"\x7fELF fake library"):
        self.blob = blob
        self.runs = 0

    def __call__(self):
        self.runs += 1
        return self.blob


def _build(store, builder, name="fused_attention_fwd", code="c0"):
    return store.load_or_build_ex(name, builder, code=code, arch="sm_90a")


def test_round_trip_miss_then_warm_hit(store):
    builder = Builder()
    blob, outcome, _ = _build(store, builder)
    assert (outcome, blob, builder.runs) == ("miss", builder.blob, 1)
    assert (store.hits, store.misses, store.bypass) == (0, 1, 0)
    warm = _fresh(store)
    blob2, outcome2, _ = _build(warm, builder)
    assert outcome2 == "hit" and blob2 == builder.blob
    assert builder.runs == 1                       # nothing was built again
    assert (warm.hits, warm.misses) == (1, 0)
    assert warm.session_summary()["cache"] == "hit"
    assert store.session_summary()["cache"] == "miss"
    arts = list(store.cache_dir.rglob("*.ptaot"))
    assert [p.parent.name for p in arts] == ["FakeGPU_H0"]
    assert arts[0].name == "fused_attention_fwd.ptaot"


def test_session_summary_keys_match_jax(store):
    jstore = jaot.ProgramCache(cache_dir=store.cache_dir / "jax",
                               enabled=True)
    assert set(store.session_summary()) == set(jstore.session_summary())
    assert store.session_summary()["cache"] == "unused"
    store.enabled = False
    assert store.session_summary()["cache"] == "disabled"


def test_disabled_store_bypasses_and_writes_nothing(store):
    store.enabled = False
    builder = Builder()
    for _ in range(2):
        _, outcome, _ = _build(store, builder)
        assert outcome == "bypass"
    assert builder.runs == 2
    assert (store.hits, store.misses, store.bypass) == (0, 0, 2)
    assert not store.cache_dir.exists()


def _artifact(store):
    _build(store, Builder())
    (path,) = list(store.cache_dir.rglob("*.ptaot"))
    return path


@pytest.mark.parametrize("mangle", [
    "truncate", "bad_magic", "torn_header", "flip_byte", "empty"])
def test_mangled_artifact_is_a_miss_not_a_crash(store, mangle, caplog):
    path = _artifact(store)
    raw = path.read_bytes()
    bad = {"truncate": raw[:-5],
           "bad_magic": b"XXXX" + raw[4:],
           "torn_header": raw[:len(aot._MAGIC) + 5],
           "flip_byte": raw[:-1] + bytes([raw[-1] ^ 0xFF]),
           "empty": b""}[mangle]
    path.write_bytes(bad)
    builder = Builder()
    with caplog.at_level(logging.WARNING, logger=aot.__name__):
        blob, outcome, _ = _build(_fresh(store), builder)
    assert outcome == "miss" and builder.runs == 1 and blob == builder.blob
    assert "MISS (corrupt)" in caplog.text
    # the rebuild replaced the corrupt artifact: the next process hits
    assert _build(_fresh(store), Builder())[1] == "hit"


def test_key_isolation_by_device_kind_and_library(store, monkeypatch):
    _build(store, Builder(b"attention"), name="fused_attention_fwd")
    builder = Builder(b"layer norm")
    assert _build(store, builder, name="layer_norm")[1] == "miss"
    monkeypatch.setattr(aot, "_device_kind", lambda: "OtherGPU B9")
    other = Builder(b"other card")
    blob, outcome, _ = _build(_fresh(store), other, name="layer_norm")
    assert (outcome, blob) == ("miss", b"other card")
    monkeypatch.setattr(aot, "_device_kind", lambda: "FakeGPU H0")
    warm = _fresh(store)
    assert _build(warm, Builder(), name="fused_attention_fwd")[0] == \
        b"attention"
    assert _build(warm, Builder(), name="layer_norm")[0] == b"layer norm"
    assert {p.parent.name for p in store.cache_dir.rglob("*.ptaot")} == {
        "FakeGPU_H0", "OtherGPU_B9"}


def test_stale_salt_misses_loudly(store, monkeypatch, caplog):
    _build(store, Builder(b"old"))
    monkeypatch.setenv(aot.ENV_SALT, "fleet-wide invalidation")
    builder = Builder(b"new")
    with caplog.at_level(logging.WARNING, logger=aot.__name__):
        blob, outcome, _ = _build(_fresh(store), builder)
    assert (outcome, blob, builder.runs) == ("miss", b"new", 1)
    assert "MISS (stale)" in caplog.text and "component=code" in caplog.text
    events = _fresh(store)
    assert _build(events, Builder())[0] == b"new"   # the rebuild was stored


@pytest.mark.parametrize("component", ["torch", "cuda", "nvcc"])
def test_toolchain_component_misses_loudly(store, monkeypatch, caplog,
                                           component):
    _build(store, Builder(b"old"))
    versions = dict(aot._toolchain_versions())
    versions[component] = "99.0"
    monkeypatch.setattr(aot, "_toolchain_versions", lambda: versions)
    with caplog.at_level(logging.WARNING, logger=aot.__name__):
        warm = _fresh(store)
        blob, outcome, _ = _build(warm, Builder(b"new"))
    assert (outcome, blob) == ("miss", b"new")
    assert f"component={component}" in caplog.text
    assert warm.session_summary()["events"][0]["reason"] == \
        f"stale:{component}"


def test_code_change_misses(store):
    _build(store, Builder(b"v1"), code="c1")
    assert _build(_fresh(store), Builder(b"v2"), code="c2")[:2] == (
        b"v2", "miss")


def test_build_errors_propagate(store):
    def broken():
        raise RuntimeError("nvcc failed on x.cu (exit 2)")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build(store, broken)
    assert not list(store.cache_dir.rglob("*.ptaot"))


# -- parse_bytes, eviction and the tool against the JAX package -------------------


@pytest.mark.parametrize("text", [
    None, "", 0, 1048576, "512", "4K", "512M", "2g", "512MB", " 3 k ", "7b",
    -5, 12.7])
def test_parse_bytes_matches_jax(text):
    assert aot.parse_bytes(text) == jaot.parse_bytes(text)


@pytest.mark.parametrize("text", ["lots", "1T", "5 MiB", "-1K"])
def test_parse_bytes_refuses_what_jax_refuses(text):
    with pytest.raises(ValueError, match="unparseable"):
        jaot.parse_bytes(text)
    with pytest.raises(ValueError, match="unparseable"):
        aot.parse_bytes(text)


_TREE = [("a", "FakeGPU_H0", 600, 1000), ("b", "FakeGPU_H0", 300, 4000),
         ("c", "OtherGPU_B9", 900, 2000), ("d", "FakeGPU_H0", 100, 3000),
         ("e", "OtherGPU_B9", 700, 5000)]


def _plant(root: Path, suffix: str, tree=_TREE):
    for name, kind, size, mtime in tree:
        path = root / kind / f"{name}{suffix}"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"x" * size)
        os.utime(path, (mtime, mtime))


@pytest.mark.parametrize("budget", [None, 0, 1, 1000, 1600, 2000, 2600,
                                    10_000])
def test_evict_to_budget_matches_jax(tmp_path, budget):
    _plant(tmp_path / "jax", ".aot")
    _plant(tmp_path / "torch", ".ptaot")
    jgone = jaot.evict_to_budget(tmp_path / "jax", budget)
    gone = aot.evict_to_budget(tmp_path / "torch", budget)
    assert [p.stem for p in gone] == [p.stem for p in jgone]
    left = sorted(p.stem for p in (tmp_path / "torch").rglob("*.ptaot"))
    assert left == sorted(p.stem for p in (tmp_path / "jax").rglob("*.aot"))


def test_each_package_reads_only_its_own_artifacts(tmp_path):
    """A shared directory (config/fleet.cfg's artifacts/aot) holds both
    packages' files: neither tool lists, verifies or evicts the other's."""
    _plant(tmp_path, ".aot", _TREE[:2])
    _plant(tmp_path, ".ptaot", _TREE[2:])
    assert {Path(r["path"]).stem for r in aot.verify_store(tmp_path)} == \
        {"c", "d", "e"}
    assert {Path(r["path"]).stem for r in jaot.verify_store(tmp_path)} == \
        {"a", "b"}
    aot.evict_to_budget(tmp_path, 1)
    assert sorted(p.name for p in tmp_path.rglob("*.*aot")) == [
        "a.aot", "b.aot"]


def _jax_artifact(path: Path) -> None:
    """A sound artifact in the JAX store's format (what its
    ``load_or_compile`` writes), without compiling a program."""
    blob = b"serialized executable"
    header = {"fingerprint": {c: "x" for c in jaot.FINGERPRINT_COMPONENTS},
              "blob_bytes": len(blob),
              "blob_sha256": hashlib.sha256(blob).hexdigest()}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(jaot._MAGIC + json.dumps(header).encode() + b"\n"
                     + blob)


def _run_tools(tmp_path, argv, capsys):
    """Both tools on mirrored stores: the exit codes and the outputs."""
    codes = []
    for mod, root in ((jaot, tmp_path / "jax"), (aot, tmp_path / "torch")):
        try:
            codes.append(mod.main(["--cache_dir", str(root), *argv]))
        except SystemExit as e:
            codes.append(("SystemExit", e.code))
    return codes, capsys.readouterr().out


def test_tool_exit_codes_match_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(aot, "_device_kind", lambda: "FakeGPU H0")
    monkeypatch.setattr(jaot, "_device_kind", lambda: "FakeGPU H0")
    # empty stores
    codes, out = _run_tools(tmp_path, ["--list"], capsys)
    assert codes == [0, 0] and out.count(": empty") == 2
    codes, _ = _run_tools(tmp_path, ["--verify"], capsys)
    assert codes == [0, 0]
    # one sound artifact each
    st = aot.ProgramCache(cache_dir=tmp_path / "torch", enabled=True)
    st.load_or_build_ex("layer_norm", Builder(), code="c", arch="sm_90a")
    _jax_artifact(tmp_path / "jax" / "FakeGPU_H0" / "unit--8----.aot")
    codes, out = _run_tools(tmp_path, [], capsys)     # no flag = --list
    assert codes == [0, 0] and out.count("total: 1 artifact(s)") == 2
    assert "code=" in out and "nvcc=" in out and "arch=sm_90a" in out
    codes, out = _run_tools(tmp_path, ["--verify"], capsys)
    assert codes == [0, 0] and out.count("1 ok, 0 corrupt") == 2
    # a corrupt artifact each: reported (exit 1), never deleted
    bad = [tmp_path / "jax" / "FakeGPU_H0" / "bad--x----.aot",
           tmp_path / "torch" / "FakeGPU_H0" / "bad--x----.ptaot"]
    for path in bad:
        path.write_bytes(b"not an artifact")
    codes, out = _run_tools(tmp_path, ["--verify"], capsys)
    assert codes == [1, 1] and out.count("1 ok, 1 corrupt") == 2
    assert out.lower().count("bad magic") == 2
    assert all(p.exists() for p in bad)
    codes, out = _run_tools(tmp_path, ["--list"], capsys)
    assert codes == [0, 0] and out.count("<corrupt (bad magic)>") == 2
    # --evict to a budget, and --evict without one is refused
    codes, out = _run_tools(tmp_path, ["--evict", "--aot_cache_bytes", "1"],
                            capsys)
    assert codes == [0, 0] and out.count("evicted 2 artifact(s)") == 2
    codes, _ = _run_tools(tmp_path, ["--evict"], capsys)
    assert codes == [("SystemExit", 2), ("SystemExit", 2)]


def test_tool_is_stdlib_only(tmp_path):
    """``python -m ml_recipe_tpu_torch.ops.aot`` runs where no torch is
    importable: the store's host needs only the standard library."""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "torch.py").write_text("raise ImportError('no torch here')\n")
    (blocker / "numpy.py").write_text("raise ImportError('no numpy here')\n")
    env = dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{REPO}")
    for argv, rc in ((["--list"], 0), (["--verify"], 0),
                     (["--evict"], 2),
                     (["--evict", "--aot_cache_bytes", "1M"], 0)):
        proc = subprocess.run(
            [sys.executable, "-m", "ml_recipe_tpu_torch.ops.aot",
             "--cache_dir", str(tmp_path / "store"), *argv],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=60)
        assert proc.returncode == rc, (argv, proc.stdout, proc.stderr)


# -- cuda_build through the store ----------------------------------------------------


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch, store):
    """A stand-in ``nvcc`` (writes ``FAKE:<source name>`` to its ``-o``
    path and logs each run) and a ctypes loader that reads the loaded
    file's bytes back."""
    log = tmp_path / "nvcc_runs.txt"
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        out = args[args.index("-o") + 1]
        if "broken" in args[-1]:
            print("error: broken.cu(1): expected a declaration")
            sys.exit(2)
        with open(out, "wb") as fh:
            fh.write(b"FAKE:" + args[-1].rsplit("/", 1)[-1].encode())
        with open({str(log)!r}, "a") as fh:
            fh.write(args[-1] + "\\n")
        """))
    script.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: SimpleNamespace(
        data=Path(path).read_bytes()))
    return log


def _libraries():
    return [cuda_build.CudaLibrary(src, lambda lib: None)
            for src in ("fused_attention_fwd.cu", "layer_norm.cu")]


def test_cuda_build_goes_through_the_store(fake_nvcc, store, monkeypatch):
    cold = _libraries()
    built = cuda_build.build(*cold)
    assert built == cold and all(lib.outcome == "miss" for lib in cold)
    assert [lib.lib().data for lib in cold] == [
        b"FAKE:fused_attention_fwd.cu", b"FAKE:layer_norm.cu"]
    assert cuda_build.build_counts() == {"hits": 0, "misses": 2}
    assert [k for k, _ in cuda_build.load_events()] == ["miss", "miss"]
    assert len(fake_nvcc.read_text().splitlines()) == 2
    assert (store.misses, store.hits) == (2, 0)

    # a restarted process: fresh libraries, a fresh store, the same
    # directory; every library is a hit and nvcc never runs
    warm_store = aot.reset()
    warm_store.enabled = True
    warm_store.set_cache_dir(store.cache_dir)
    warm = _libraries()
    reads = []
    read_artifact = aot._read_artifact
    monkeypatch.setattr(aot, "_read_artifact",
                        lambda path: reads.append(path) or read_artifact(path))
    assert cuda_build.build(*warm) == []
    assert len(reads) == 2          # each artifact is read once per load
    assert [lib.lib().data for lib in warm] == [lib.lib().data for lib in cold]
    assert all(lib.outcome == "hit" and not lib.built for lib in warm)
    assert cuda_build.build_counts() == {"hits": 2, "misses": 0}
    assert [k for k, _ in cuda_build.load_events()] == ["hit", "hit"]
    assert len(fake_nvcc.read_text().splitlines()) == 2
    assert (warm_store.hits, warm_store.misses) == (2, 0)
    assert aot.main(["--cache_dir", str(store.cache_dir), "--verify"]) == 0


def test_cuda_build_with_the_store_off_builds_each_time(fake_nvcc, store):
    store.enabled = False
    for _ in range(2):
        (lib,) = _libraries()[:1]
        assert lib.lib().data == b"FAKE:fused_attention_fwd.cu"
        assert lib.outcome == "bypass" and lib.built
    assert cuda_build.build_counts() == {"hits": 0, "misses": 2}
    assert store.bypass == 2 and not store.cache_dir.exists()


def test_cuda_build_errors_propagate_and_write_nothing(fake_nvcc, store,
                                                       monkeypatch):
    lib = cuda_build.CudaLibrary("layer_norm.cu", lambda lib: None)
    monkeypatch.setattr(lib, "source", Path("/nonexistent/broken.cu"))
    monkeypatch.setattr(lib, "code", lambda: "broken")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        lib.lib()
    assert lib.blob is None and not list(store.cache_dir.rglob("*.ptaot"))


def test_kernel_count_on_the_cpu():
    kernel = cuda_build.Kernel(_libraries()[0])
    kernel.count()
    kernel.count()
    assert (kernel.launches, kernel.captured) == (2, 0)
