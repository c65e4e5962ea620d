"""The port's data path against the JAX package's, on the CPU.

* ``ops/degrade.cold_degrade`` is bit-exact with JAX's at every level of the
  64px and 200px tables (and with the host numpy path); ``normalize_base``
  and ``make_cold_prepare`` likewise; ``smooth_l1`` to f32 rounding
  (rtol 1e-6: the same f32 mean, summed in another order);
* ``data/resize.py`` is the JAX module's copy: identical arrays;
* the datasets and the loader, on the ``synthetic_image_dir`` fixture (ten
  96×80 jpgs, resized by the PIL tier), against JAX's at ``use_native=False``:
  identical t draws, identical (noisy, target) and raw (base, t) arrays, and
  the same batch order per (seed, epoch). Exact equality throughout: both
  sides run the same numpy code on the same decoded bytes. (The native
  tier, ``use_native=True``, is held in ``test_torch_port_native.py``.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddim_cold_torch.data import ColdDownSampleDataset, ShardedLoader
from ddim_cold_torch.data import loader as port_loader
from ddim_cold_torch.data import resize as port_resize
from ddim_cold_torch.ops import degrade as port_degrade
from ddim_cold_torch.ops.losses import smooth_l1
from ddim_cold_tpu.data import datasets as jax_datasets
from ddim_cold_tpu.data import loader as jax_loader
from ddim_cold_tpu.data import resize as jax_resize
from ddim_cold_tpu.ops import degrade as jax_degrade
from ddim_cold_tpu.ops.losses import smooth_l1 as jax_smooth_l1


@pytest.mark.parametrize("size,max_step", [(16, 4), (64, 6), (200, 7)])
def test_cold_degrade_bit_exact_with_jax_at_every_level(size, max_step):
    rs = np.random.RandomState(size)
    levels = np.arange(max_step + 1, dtype=np.int32)
    x = rs.randn(len(levels), size, size, 3).astype(np.float32)
    got = port_degrade.cold_degrade(torch.from_numpy(x), torch.from_numpy(levels),
                                    size=size, max_step=max_step).numpy()
    want = np.asarray(jax_degrade.cold_degrade(jnp.asarray(x), jnp.asarray(levels),
                                               size=size, max_step=max_step))
    np.testing.assert_array_equal(got, want)
    for lv in levels:  # and the host pipeline's numpy resize
        np.testing.assert_array_equal(got[lv], port_resize.cold_degrade(x[lv], 2**lv, size))


def test_cold_degrade_refuses_a_level_past_its_table():
    x = torch.zeros((1, 16, 16, 3))
    with pytest.raises(IndexError):
        port_degrade.cold_degrade(x, torch.tensor([5]), size=16, max_step=4)


@pytest.mark.parametrize("chain", [True, False])
def test_cold_prepare_matches_jax_from_uint8_and_float(chain):
    rs = np.random.RandomState(1)
    base = rs.randint(0, 256, size=(5, 64, 64, 3)).astype(np.uint8)
    t = np.array([1, 2, 3, 5, 6], np.int32)
    want = jax_degrade.make_cold_prepare(64, 6, chain)((jnp.asarray(base), jnp.asarray(t)), None)
    got = port_degrade.make_cold_prepare(64, 6, chain)(
        (torch.from_numpy(base), torch.from_numpy(t)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f32 = base.astype(np.float32) / 255.0 * 2.0 - 1.0  # the host path's base
    np.testing.assert_array_equal(
        port_degrade.normalize_base(torch.from_numpy(base)).numpy(), f32)
    got_f = port_degrade.make_cold_prepare(64, 6, chain)(
        (torch.from_numpy(f32), torch.from_numpy(t)))
    np.testing.assert_array_equal(got_f[0].numpy(), got[0].numpy())


def test_gaussian_prepare_draws_from_the_generator():
    """ε from the step's generator under ᾱ(t) = 1 − √((t+1)/T); the target
    is x₀ (no JAX bit-parity: the two RNGs differ)."""
    x = torch.from_numpy(np.random.RandomState(2).rand(3, 8, 8, 3).astype(np.float32))
    t = torch.tensor([0, 999, 1999], dtype=torch.int32)
    prep = port_degrade.make_gaussian_prepare(2000)
    noisy, target, t_out = prep((x, t), torch.Generator().manual_seed(7))
    eps = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    a = 1.0 - torch.sqrt((t.float() + 1.0) / 2000)[:, None, None, None]
    torch.testing.assert_close(noisy, torch.sqrt(a) * x + torch.sqrt(1 - a) * eps)
    assert torch.equal(target, x) and torch.equal(t_out, t)


def test_smooth_l1_matches_jax():
    rs = np.random.RandomState(3)
    pred, target = rs.randn(4, 8, 8, 3) * 2, rs.randn(4, 8, 8, 3)
    got = smooth_l1(torch.from_numpy(pred).float(), torch.from_numpy(target).to(torch.bfloat16))
    want = jax_smooth_l1(jnp.asarray(pred, jnp.float32), jnp.asarray(target, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_resize_is_the_jax_modules_copy():
    img = np.random.RandomState(4).rand(37, 29, 3).astype(np.float32)
    for out in ((16, 16), (64, 48), (5, 80)):
        np.testing.assert_array_equal(port_resize.resize_bilinear(img, out),
                                      jax_resize.resize_bilinear(img, out))
        np.testing.assert_array_equal(port_resize.resize_nearest(img, out),
                                      jax_resize.resize_nearest(img, out))
    for n_out, n_in in ((7, 200), (200, 3), (64, 64)):
        np.testing.assert_array_equal(port_resize.nearest_indices(n_out, n_in),
                                      jax_resize.nearest_indices(n_out, n_in))


@pytest.mark.parametrize("kind", ["chain", "direct", "gaussian"])
def test_dataset_items_and_raw_batches_match_jax(synthetic_image_dir, kind):
    """Per (seed, epoch, index): the same t, the same (noisy, target) and the
    same raw (base, t) batch as the JAX dataset at use_native=False."""
    if kind == "gaussian":
        mk = lambda mod, **kw: mod.DiffusionDataset(  # noqa: E731
            synthetic_image_dir, imgSize=(16, 16), max_step=2000, seed=3,
            use_native=False, **kw)
    else:
        mk = lambda mod, **kw: mod.ColdDownSampleDataset(  # noqa: E731
            synthetic_image_dir, imgSize=(16, 16), target_mode=kind, seed=3,
            use_native=False, **kw)
    import ddim_cold_torch.data.datasets as port_datasets

    port, ref = mk(port_datasets, cache_images=False), mk(jax_datasets, cache_images=True)
    assert port.imgList == ref.imgList and len(port) == len(ref) == 10
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(port)):
            for g, w in zip(port[i], ref[i]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        idx = [7, 0, 3]
        for g, w in zip(port.get_raw_batch(idx), ref.get_raw_batch(idx)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("raw", [False, True])
def test_loader_batch_order_matches_jax(synthetic_image_dir, raw):
    """Shuffled train loader (drop_last) and padded eval loader: the same
    batches, in the same order, per seed and epoch, as the JAX loader at one
    shard; threaded and unthreaded iteration agree."""
    port_ds = ColdDownSampleDataset(synthetic_image_dir, imgSize=(16, 16),
                                    use_native=False)
    ref_ds = jax_datasets.ColdDownSampleDataset(synthetic_image_dir, imgSize=(16, 16),
                                                use_native=False)
    for kw in (dict(shuffle=True, seed=42, drop_last=True),
               dict(shuffle=False, drop_last=False, pad_final_batch=True)):
        port = ShardedLoader(port_ds, 3, raw=raw, **kw)
        ref = jax_loader.ShardedLoader(ref_ds, 3, raw=raw, num_threads=1, **kw)
        serial = ShardedLoader(port_ds, 3, raw=raw, num_threads=1, **kw)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            for ld in (port, ref, serial):
                ld.set_epoch(epoch)
            got, want, again = list(port), list(ref), list(serial)
            assert len(got) == len(want) == len(port)
            for gb, wb, sb in zip(got, want, again):
                for g, w, s in zip(gb, wb, sb):
                    np.testing.assert_array_equal(g, w)
                    np.testing.assert_array_equal(g, s)


def test_device_prefetch_on_cpu_and_group_batches():
    batches = [(np.full((2, 3), i, np.float32), np.array([i, i], np.int32)) for i in range(5)]
    out = list(port_loader.device_prefetch(iter(batches), "cpu"))
    assert len(out) == 5
    for i, (x, t) in enumerate(out):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i))) and t.tolist() == [i, i]
    grouped = list(port_loader.group_batches(batches, 2))
    assert len(grouped) == 2 and grouped[0][0].shape == (2, 2, 3)
    np.testing.assert_array_equal(grouped[1][1], [[2, 2], [3, 3]])


def test_loader_surfaces_a_decode_failure(tmp_path):
    """A failing item raises at the consuming next(), path attached, from
    the threaded loader."""
    from PIL import Image

    for i in range(4):
        Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(tmp_path / f"{i}.jpg")
    (tmp_path / "2.jpg").write_bytes(b"not a jpeg")
    ds = ColdDownSampleDataset(str(tmp_path), imgSize=(16, 16), cache_images=False)
    with pytest.raises(Exception, match="2.jpg"):
        list(ShardedLoader(ds, 2, shuffle=False, drop_last=False))
