"""The port's native decode tier against the JAX package's, on the CPU.

* ``ddim_cold_torch.data.native`` (the port's own ctypes binding, built into
  ``build/ddim_cold_torch/``) against ``ddim_cold_tpu.data.native`` (the
  JAX package's, built into ``native/``), byte for byte, on JPG, PNG and
  grey PNG files: every entry point; a BMP gives None (PIL's file);
* the port's datasets at ``use_native=True`` against the port's PIL tier and
  against JAX's datasets at ``use_native=True``: ``get_batch``,
  ``get_raw_batch`` and ``__getitem__`` of both dataset kinds, with and
  without the cache, on a mixed folder (float bases) and on a uniform one
  (raw uint8 bases), bitwise;
* the loader takes ``get_batch`` (``ShardedLoader.routes``);
  ``DDIM_COLD_NO_NATIVE`` turns the tier off; a build the compiler refused
  is remembered on disk; ``data.next`` fires with JAX's tag and an injected
  fault surfaces at the consumer's ``next()``.

Exact equality throughout: the same C++ source and the same numpy code run
on the same files. Skipped when the port's library cannot be built here,
as ``tests/test_native.py`` skips.
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import ddim_cold_torch.data.datasets as port_datasets
from ddim_cold_torch.data import ShardedLoader
from ddim_cold_torch.data import native as port_native
from ddim_cold_torch.utils import faults as port_faults
from ddim_cold_tpu.data import datasets as jax_datasets
from ddim_cold_tpu.data import loader as jax_loader
from ddim_cold_tpu.data import native as jax_native
from ddim_cold_tpu.utils import faults as jax_faults

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not port_native.available(),
                                reason="the port's native library cannot be built here")


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """jpg, png, grey png and one bmp (the PIL tier inside native batches)."""
    root = tmp_path_factory.mktemp("port_native_mixed")
    rs = np.random.RandomState(11)
    for i, ext in enumerate(["jpg", "png", "jpg", "bmp", "png", "jpg"]):
        Image.fromarray(rs.randint(0, 255, (40 + 3 * i, 52 - 2 * i, 3),
                                   dtype=np.uint8)).save(root / f"{i}.{ext}")
    Image.fromarray(rs.randint(0, 255, (36, 30), dtype=np.uint8)).save(root / "7_grey.png")
    return str(root)


@pytest.fixture(scope="module")
def uniform_dir(tmp_path_factory):
    """Every file exactly 16×16: the datasets store and ship raw uint8."""
    root = tmp_path_factory.mktemp("port_native_uniform")
    rs = np.random.RandomState(12)
    for i, ext in enumerate(["png", "jpg", "png", "jpg", "png"]):
        Image.fromarray(rs.randint(0, 255, (16, 16, 3), dtype=np.uint8)).save(
            root / f"{i}.{ext}")
    return str(root)


def _files(root):
    return [os.path.join(root, n) for n in sorted(os.listdir(root))]


def _same(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


ENTRY_POINTS = {
    "load_base": lambda mod, files: tuple(mod.load_base(f, (24, 20)) for f in files),
    "cold_degrade": lambda mod, files: tuple(
        mod.cold_degrade(np.random.RandomState(5).randn(16, 16, 3).astype(np.float32),
                         2**t) for t in range(1, 5)),
    "cold_item": lambda mod, files: tuple(mod.cold_item(f, 16, 1 + i % 4, i % 2 == 0)
                                          for i, f in enumerate(files)),
    "cold_batch": lambda mod, files: mod.cold_batch(
        files, [1 + i % 4 for i in range(len(files))], 16, True, num_threads=3),
    "cold_pair_batch": lambda mod, files: mod.cold_pair_batch(
        np.random.RandomState(6).randn(4, 16, 16, 3).astype(np.float32), [1, 2, 3, 4],
        False, num_threads=2),
    "decode_batch": lambda mod, files: mod.decode_batch(files, (40, 52), num_threads=2),
    "base_batch": lambda mod, files: mod.base_batch(files, (20, 24), num_threads=4),
}


def _filled(out):
    """A batch entry point's buffers with the failed slots (left unwritten
    for the caller's PIL redo) zeroed."""
    if isinstance(out, tuple) and len(out) in (2, 3) and out[-1].dtype == bool:
        return tuple(np.where(out[-1].reshape(-1, *[1] * (a.ndim - 1)), 0, a)
                     for a in out[:-1]) + (out[-1],)
    return out


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_byte_for_byte_jax(mixed_dir, name):
    files = _files(mixed_dir)
    got = _filled(ENTRY_POINTS[name](port_native, files))
    _same(got, _filled(ENTRY_POINTS[name](jax_native, files)))
    if name == "load_base":  # the bmp is PIL's; every other file native's
        assert [g is None for g in got] == [f.endswith(".bmp") for f in files]
    if name in ("cold_batch", "base_batch"):
        assert got[-1].tolist() == [f.endswith(".bmp") for f in files]
    if name == "decode_batch":  # only the one file of exactly (40, 52)
        assert (~got[1]).sum() == 1


def _pair(root, kind, use_native_port, cache, seed=3):
    """(port dataset, JAX dataset at use_native=True) of one kind."""
    def mk(mod, use_native):
        if kind == "gaussian":
            return mod.DiffusionDataset(root, imgSize=(16, 16), max_step=2000, seed=seed,
                                        use_native=use_native, cache_images=cache)
        return mod.ColdDownSampleDataset(root, imgSize=(16, 16), target_mode=kind,
                                         seed=seed, use_native=use_native,
                                         cache_images=cache)

    return mk(port_datasets, use_native_port), mk(jax_datasets, True)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("kind", ["chain", "direct", "gaussian"])
@pytest.mark.parametrize("folder", ["mixed", "uniform"])
def test_datasets_native_match_pil_tier_and_jax(mixed_dir, uniform_dir, folder, kind,
                                                cache):
    root = mixed_dir if folder == "mixed" else uniform_dir
    port, ref = _pair(root, kind, True, cache)
    pil, _ = _pair(root, kind, False, cache)
    assert port._uniform_u8 == ref._uniform_u8 == (folder == "uniform")
    idx = [4, 0, 3, 1]
    for epoch in (0, 2):
        for ds in (port, ref, pil):
            ds.set_epoch(epoch)
        raw = port.get_raw_batch(idx, num_threads=2)
        _same(raw, ref.get_raw_batch(idx, num_threads=2))
        assert raw[0].dtype == (np.uint8 if folder == "uniform" else np.float32)
        want = ref.get_batch(idx, num_threads=2)
        _same(port.get_batch(idx, num_threads=2), want)
        assert pil.get_batch(idx) is None  # the PIL tier has no fast path
        pil_batch = [pil[i] for i in idx]
        for j in range(3):
            np.testing.assert_array_equal(want[j], np.stack([it[j] for it in pil_batch]))
        for i in idx:
            for g, w in zip(port[i], ref[i]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("raw", [False, True])
def test_loader_takes_the_native_fast_path(mixed_dir, raw):
    """Every batch from get_batch (or get_raw_batch), none item by item,
    and the batches are the JAX loader's."""
    port, ref = _pair(mixed_dir, "chain", True, False)
    kw = dict(shuffle=True, seed=42, drop_last=True, raw=raw)
    ld = ShardedLoader(port, 3, num_threads=2, **kw)
    want = list(jax_loader.ShardedLoader(ref, 3, num_threads=1, **kw))
    got = list(ld)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(tuple(g), tuple(w))
    assert dict(ld.routes) == {"raw" if raw else "get_batch": 2}


def test_kill_switch_turns_the_tier_off(mixed_dir, monkeypatch):
    port, _ = _pair(mixed_dir, "chain", True, False)
    want = ShardedLoader(port, 3, shuffle=False, num_threads=1)
    want_batches = list(want)
    monkeypatch.setenv("DDIM_COLD_NO_NATIVE", "1")
    assert not port_native.available() and not port_native.has_decode_batch()
    assert port_native.load_base(_files(mixed_dir)[0], (8, 8)) is None
    before = port_datasets.PIL_DECODES["files"]
    ld = ShardedLoader(port, 3, shuffle=False, num_threads=1)
    got = list(ld)
    assert dict(ld.routes) == {"per_item": 2}  # 7 files, batches of 3, drop_last
    assert port_datasets.PIL_DECODES["files"] - before == 6
    for g, w in zip(got, want_batches):
        _same(tuple(g), tuple(w))
    monkeypatch.delenv("DDIM_COLD_NO_NATIVE")
    assert port_native.available()


def test_library_lands_in_build_never_in_native():
    path = Path(port_native.library_path())
    assert path.parent == ROOT / "build" / "ddim_cold_torch"
    assert path.name.startswith("libddim_data-") and path.is_file()
    assert Path(port_native._lib._name) == path != Path(jax_native._SO_PATH)
    assert Path(port_native.SOURCE) == ROOT / "native" / "ddim_data.cc"
    assert "-ffp-contract=off" in port_native.CXXFLAGS


def test_refused_build_is_remembered_beside_the_library(tmp_path, monkeypatch):
    """A compiler error is written to <library>.err once; a later process
    (here: the module's in-memory state reset) reads it and runs no g++."""
    calls = []

    def refuse(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "fatal error: jpeglib.h: none\n")

    monkeypatch.setattr(port_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(port_native.subprocess, "run", refuse)
    monkeypatch.setattr(port_native, "library_path",
                        lambda: str(tmp_path / "libddim_data-x.so"))
    for _ in range(2):
        monkeypatch.setattr(port_native, "_lib", None)
        monkeypatch.setattr(port_native, "_lib_failed", False)
        monkeypatch.setattr(port_native, "_build_error", None)
        assert not port_native.available()
        assert port_native.build_error() == "fatal error: jpeglib.h: none\n"
    assert len(calls) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libddim_data-x.so.err"]


def test_data_next_fires_with_jax_tag_and_surfaces_at_next():
    class Toy:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            x = np.full((4, 4, 3), float(i), np.float32)
            return x, x, i

    plans = []
    for cls, faults in ((jax_loader.ShardedLoader, jax_faults), (ShardedLoader, port_faults)):
        ld = cls(Toy(), batch_size=4, shuffle=False, num_threads=2)
        ld.set_epoch(5)
        spec = faults.FaultSpec("data.next", "permanent", at=(1,))
        with faults.inject(spec) as plan:
            it = iter(ld)
            np.testing.assert_array_equal(next(it)[2], [0, 1, 2, 3])
            with pytest.raises(faults.PermanentFault):
                next(it)
            plans.append([(r["site"], r["call"], r["tag"]) for r in plan.realized])
    assert plans[0] == plans[1] == [("data.next", 1, "epoch:5|")]
