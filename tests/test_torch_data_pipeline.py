"""horovod_tpu_torch.data against horovod_tpu.data.

The counterpart of every case of ``tests/test_data_pipeline.py`` that
has one in the port (sources, sharding, the worker pool, the
prefetcher's order, run-ahead bound, error propagation and
``poll``/``restart`` contract, the loader, the instruments), plus the
bit-equality of the two packages: the same source, seed, epoch, rank
and world give the same epoch orders, shards and batches.  The port
yields tensors (CPU tensors here: ``device="cpu"`` or
``device_put=False``); the card path, a pinned copy on a side stream,
runs in ``chip_smoke.py``'s pipeline phase.
"""

import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import data as jdata
from horovod_tpu_torch import data
from horovod_tpu_torch.data import prefetch as prefetch_mod
from horovod_tpu_torch.data import workers as workers_mod
from horovod_tpu_torch.metrics import instruments as instr


def _array_source(n=32, size=4, pkg=data):
    """inputs[i] encodes i so order/identity assertions are trivial."""
    inputs = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones(
        (n, size, size, 3), np.float32)
    labels = np.arange(n, dtype=np.int32)
    return pkg.ArraySource(inputs, labels)


# -- sources -----------------------------------------------------------------


def test_synthetic_source_deterministic_per_index():
    s = data.SyntheticSource(64, image_size=6, seed=7)
    a, la = s.batch([3, 11, 3])
    b, lb = s.batch([11, 3, 5])
    assert np.array_equal(a[0], b[1]) and la[0] == lb[1]
    assert np.array_equal(a[1], b[0]) and la[1] == lb[0]
    assert np.array_equal(a[0], a[2])
    one, lbl = s.sample(11)
    assert np.array_equal(one, a[1]) and lbl == la[1]
    assert 0 <= lbl < s.num_classes


def test_synthetic_source_bytes_equal_reference():
    idx = [0, 5, 63, 17, 5]
    got = data.SyntheticSource(64, image_size=6, seed=7).batch(idx)
    want = jdata.SyntheticSource(64, image_size=6, seed=7).batch(idx)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_npy_shard_source_round_trip(tmp_path):
    n = 23
    inputs = np.random.RandomState(0).randint(
        0, 256, size=(n, 5, 5, 3), dtype=np.uint8)
    labels = np.arange(n, dtype=np.int64)
    stems = data.write_npy_shards(str(tmp_path), inputs, labels,
                                  num_shards=4)
    assert len(stems) == 4
    src = data.NpyShardSource(str(tmp_path))
    assert len(src) == n
    idx = [22, 0, 7, 13, 7, 19]
    bx, by = src.batch(idx)
    assert np.array_equal(by, labels[idx])
    assert np.array_equal(bx, inputs[idx])
    sx, sy = src.sample(13)
    assert np.array_equal(sx, inputs[13]) and sy == 13
    # the reference reads the port's shards byte for byte, and the reverse
    ref = jdata.NpyShardSource(str(tmp_path))
    for g, w in zip(src.batch(idx), ref.batch(idx)):
        np.testing.assert_array_equal(g, w)
    jdata.write_npy_shards(str(tmp_path / "ref"), inputs, labels,
                           num_shards=3)
    np.testing.assert_array_equal(
        data.NpyShardSource(str(tmp_path / "ref")).batch(idx)[0],
        inputs[idx])


def test_npy_shard_source_rejects_empty_and_mismatch(tmp_path):
    with pytest.raises(FileNotFoundError):
        data.NpyShardSource(str(tmp_path))
    np.save(tmp_path / "shard-00000-inputs.npy", np.zeros((3, 2)))
    np.save(tmp_path / "shard-00000-labels.npy", np.zeros((2,)))
    with pytest.raises(ValueError, match="disagree"):
        data.NpyShardSource(str(tmp_path))


def test_image_folder_source(tmp_path):
    from PIL import Image

    for cls, color in [("cats", (255, 0, 0)), ("dogs", (0, 255, 0))]:
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            Image.new("RGB", (10 + i, 12), color).save(d / f"img{i}.png")
    src = data.ImageFolderSource(str(tmp_path), image_size=8)
    assert len(src) == 6
    assert src.classes == ["cats", "dogs"]
    img, label = src.sample(0)
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    assert label == 0 and np.all(img[:, :, 0] == 255)
    img, label = src.sample(5)
    assert label == 1 and np.all(img[:, :, 1] == 255)
    bx, by = src.batch([0, 5])
    assert bx.shape == (2, 8, 8, 3) and list(by) == [0, 1]
    ref = jdata.ImageFolderSource(str(tmp_path), image_size=8)
    np.testing.assert_array_equal(bx, ref.batch([0, 5])[0])


def test_open_source_dispatch(tmp_path):
    assert isinstance(data.open_source("synthetic", num_samples=4),
                      data.SyntheticSource)
    with pytest.raises(ValueError, match="requires a dataset path"):
        data.open_source("npy")
    with pytest.raises(ValueError, match="unknown data source"):
        data.open_source("parquet", "/nope")


# -- sharding ----------------------------------------------------------------


def test_shards_partition_the_epoch():
    n, world = 37, 4
    seen = []
    lengths = set()
    for r in range(world):
        s = data.ShardedIndexSampler(
            n, shard=data.ShardSpec(r, world), shuffle=True, seed=3)
        idx = s.shard_indices()
        lengths.add(len(idx))
        seen.extend(idx.tolist())
    assert lengths == {n // world}
    assert len(seen) == len(set(seen))


def test_shard_reshuffles_per_epoch_deterministically():
    s = data.ShardedIndexSampler(32, shard=data.ShardSpec(0, 2), seed=1)
    e0 = s.shard_indices()
    s.set_epoch(1)
    e1 = s.shard_indices()
    assert not np.array_equal(e0, e1)
    s.set_epoch(0)
    assert np.array_equal(s.shard_indices(), e0)


def test_world_resize_reshards_same_epoch_order():
    n = 24
    full = data.ShardedIndexSampler(
        n, shard=data.ShardSpec(0, 1), seed=5).shard_indices()
    for world in (2, 3):
        got = np.empty(n, dtype=np.int64)
        for r in range(world):
            sl = data.ShardedIndexSampler(
                n, shard=data.ShardSpec(r, world), seed=5).shard_indices()
            got[r::world] = sl
        assert np.array_equal(got, full)


@pytest.mark.parametrize("n,world,seed,shuffle,drop", [
    (37, 4, 3, True, True), (100, 3, 0, True, False), (64, 1, 9, False, True),
    (1000, 8, 123, True, True), (50, 7, 2, True, False)])
def test_epoch_orders_and_batches_equal_reference(n, world, seed, shuffle,
                                                  drop):
    for epoch in (0, 1, 5):
        for rank in range(world):
            kw = dict(shuffle=shuffle, seed=seed, drop_remainder=drop)
            got = data.ShardedIndexSampler(
                n, shard=data.ShardSpec(rank, world), **kw)
            want = jdata.ShardedIndexSampler(
                n, shard=jdata.ShardSpec(rank, world), **kw)
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            np.testing.assert_array_equal(got.shard_indices(),
                                          want.shard_indices())
            assert got.num_batches(4) == want.num_batches(4)
            for a, b in zip(got.batches(4), want.batches(4), strict=True):
                np.testing.assert_array_equal(a, b)


def test_current_shard_follows_topology():
    import horovod_tpu_torch as hvd

    assert data.current_shard() == data.ShardSpec(0, 1)  # before init
    hvd.init(device="cpu")
    try:
        spec = data.current_shard()
        assert spec.num_shards == hvd.cross_size()
        assert spec.shard == hvd.cross_rank()
    finally:
        hvd.shutdown()


def test_batches_drop_remainder_static_shapes():
    s = data.ShardedIndexSampler(30, shard=data.ShardSpec(0, 1),
                                 shuffle=False)
    batches = list(s.batches(8))
    assert [len(b) for b in batches] == [8, 8, 8]
    assert s.num_batches(8) == 3
    s2 = data.ShardedIndexSampler(30, shard=data.ShardSpec(0, 1),
                                  shuffle=False, drop_remainder=False)
    assert [len(b) for b in s2.batches(8)] == [8, 8, 8, 6]


# -- worker pool -------------------------------------------------------------


def test_map_ordered_preserves_order_under_jitter():
    def slow_square(i):
        time.sleep(0.002 * ((i * 7) % 5))
        return i * i

    out = list(workers_mod.map_ordered(slow_square, range(20),
                                       num_workers=4, window=6))
    assert out == [i * i for i in range(20)]


def test_map_ordered_inline_when_zero_workers():
    main = threading.get_ident()
    tids = []

    def probe(i):
        tids.append(threading.get_ident())
        return i

    assert list(workers_mod.map_ordered(probe, range(3),
                                        num_workers=0)) == [0, 1, 2]
    assert set(tids) == {main}


def test_map_ordered_propagates_errors_in_order():
    def maybe_fail(i):
        if i == 3:
            raise RuntimeError("boom")
        return i

    it = workers_mod.map_ordered(maybe_fail, range(6), num_workers=2,
                                 window=4)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_default_num_workers_env(monkeypatch):
    monkeypatch.setenv(workers_mod.WORKERS_ENV, "7")
    assert workers_mod.default_num_workers() == 7
    monkeypatch.setenv(workers_mod.WORKERS_ENV, "-1")
    with pytest.raises(ValueError):
        workers_mod.default_num_workers()
    monkeypatch.delenv(workers_mod.WORKERS_ENV)
    assert workers_mod.default_num_workers() >= 1


# -- device prefetcher -------------------------------------------------------


def test_prefetcher_yields_all_batches_in_order():
    batches = [(np.full((2, 3), i, np.float32), np.array([i, i])) for i in
               range(7)]
    pf = data.DevicePrefetcher(iter(batches), depth=2, device_put=False)
    got = [b for b in pf]
    assert [int(b[0][0, 0]) for b in got] == list(range(7))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in got for t in b)
    with pytest.raises(StopIteration):
        next(pf)
    stats = pf.stats()
    assert stats["batches"] == 7 and stats["prefetch_depth"] == 2


def test_prefetcher_bounded_runahead():
    produced = []

    def gen():
        for i in range(10):
            produced.append(i)
            yield (np.zeros(1),)

    pf = data.DevicePrefetcher(gen(), depth=2, device_put=False)
    time.sleep(0.3)
    assert len(produced) <= 3  # depth staged + 1 in the producer's hand
    list(pf)
    assert len(produced) == 10


def test_prefetcher_depth_zero_is_synchronous():
    pf = data.DevicePrefetcher(iter([(np.ones(2),)] * 3), depth=0,
                               device_put=False)
    assert pf._thread is None
    assert len(list(pf)) == 3


def test_prefetcher_propagates_producer_error():
    def gen():
        yield (np.zeros(1),)
        raise ValueError("decode failed")

    pf = data.DevicePrefetcher(gen(), depth=2, device_put=False)
    next(pf)
    with pytest.raises(ValueError, match="decode failed"):
        next(pf)
    with pytest.raises(ValueError, match="decode failed"):
        next(pf)


def test_prefetcher_poll_and_exhausted_marker():
    pf = data.DevicePrefetcher(
        iter([(np.full(2, i),) for i in range(3)]), depth=2,
        device_put=False, source_kind="serving")
    got = []
    while True:
        item = pf.poll(block=True)
        if item is pf.EXHAUSTED:
            break
        got.append(int(item[0][0]))
    assert got == [0, 1, 2]
    assert pf.exhausted
    assert pf.poll() is pf.EXHAUSTED
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_poll_depth_zero_synchronous():
    pf = data.DevicePrefetcher(iter([(np.ones(1),)] * 2), depth=0,
                               device_put=False)
    assert pf.poll() is not None and pf.poll(block=True) is not None
    assert pf.poll() is pf.EXHAUSTED
    assert pf.exhausted


def test_prefetcher_poll_after_close_returns_exhausted():
    pf = data.DevicePrefetcher(iter([(np.ones(1),)] * 5), depth=2,
                               device_put=False)
    pf.close()
    assert pf.poll(block=True) is pf.EXHAUSTED
    assert pf.poll() is pf.EXHAUSTED


def test_prefetcher_restart_contract():
    pf = data.DevicePrefetcher(iter([(np.zeros(1),)] * 2), depth=2,
                               device_put=False)
    with pytest.raises(RuntimeError, match="active"):
        pf.restart(iter([]))
    assert len(list(pf)) == 2 and pf.exhausted
    pf.restart(iter([(np.ones(1),)] * 3))
    assert not pf.exhausted
    assert len(list(pf)) == 3
    assert pf.stats()["batches"] == 5
    pf.close()
    assert pf.closed
    pf.restart(iter([(np.ones(1),)]))
    assert not pf.closed and len(list(pf)) == 1
    pf.close()


def test_prefetcher_restart_does_not_leak_old_stream():
    def stale():
        for _ in range(50):
            yield (np.full(1, -1.0),)

    pf = data.DevicePrefetcher(stale(), depth=1, device_put=False)
    time.sleep(0.1)
    pf.close()
    pf.restart(iter([(np.full(1, float(i)),) for i in range(4)]))
    got = [float(b[0][0]) for b in pf]
    assert got == [0.0, 1.0, 2.0, 3.0], got
    pf.close()


def test_prefetcher_bf16_cast_floats_only():
    pf = data.DevicePrefetcher(
        iter([(np.ones((2, 2), np.float32), np.array([1, 2], np.int32))]),
        depth=1, cast="bfloat16", device="cpu")
    x, y = next(pf)
    assert x.dtype == torch.bfloat16
    assert y.dtype == torch.int32
    with pytest.raises(ValueError, match="floating"):
        data.DevicePrefetcher(iter([]), depth=0, cast="int8",
                              device_put=False)


def test_prefetcher_default_device_is_the_card():
    """Without ``device`` the prefetcher places batches on the card, and
    with none it raises instead of quietly staying on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        data.DevicePrefetcher(iter([]), depth=0)


def test_prefetch_depth_env(monkeypatch):
    monkeypatch.setenv(prefetch_mod.PREFETCH_ENV, "5")
    assert prefetch_mod.default_prefetch_depth() == 5
    monkeypatch.setenv(prefetch_mod.PREFETCH_ENV, "-2")
    with pytest.raises(ValueError):
        prefetch_mod.default_prefetch_depth()
    monkeypatch.delenv(prefetch_mod.PREFETCH_ENV)
    assert prefetch_mod.default_prefetch_depth() == 2


# -- loader end-to-end -------------------------------------------------------


def test_loader_device_batches_and_len():
    src = _array_source(n=32)
    loader = data.DataLoader(src, batch_size=4, shuffle=False,
                             shard=data.ShardSpec(0, 1), device="cpu",
                             num_workers=2, prefetch_depth=2)
    assert len(loader) == 8
    batches = list(loader)
    assert len(batches) == 8
    assert isinstance(batches[0][0], torch.Tensor)
    flat = np.concatenate([b[1].numpy() for b in batches])
    assert np.array_equal(flat, np.arange(32))
    assert loader.stats()["batches"] == 8


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 9])
def test_loader_batches_equal_reference(world, seed):
    """Same source, seed, epoch, rank and world: the port's batches are
    the reference loader's, bit for bit, in order."""
    n = 40
    rs = np.random.RandomState(seed)
    inputs = rs.randn(n, 3, 3, 2).astype(np.float32)
    labels = rs.randint(0, 10, (n,)).astype(np.int32)
    for rank in range(world):
        kw = dict(batch_size=4, seed=seed, device_put=False, num_workers=2,
                  prefetch_depth=2)
        got = data.DataLoader(data.ArraySource(inputs, labels),
                              shard=data.ShardSpec(rank, world), **kw)
        want = jdata.DataLoader(jdata.ArraySource(inputs, labels),
                                shard=jdata.ShardSpec(rank, world), **kw)
        for epoch in (0, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            pairs = list(zip(got, want, strict=True))
            assert len(pairs) == len(want) == (n // world) // 4
            for (gx, gy), (wx, wy) in pairs:
                np.testing.assert_array_equal(gx.numpy(), wx)
                np.testing.assert_array_equal(gy.numpy(), wy)


def test_loader_shards_cover_world_disjointly():
    src = _array_source(n=32)
    seen = []
    for r in range(4):
        loader = data.DataLoader(src, batch_size=2, seed=9,
                                 shard=data.ShardSpec(r, 4),
                                 device_put=False, num_workers=0,
                                 prefetch_depth=0)
        for _, labels in loader:
            seen.extend(labels.tolist())
    assert sorted(seen) == list(range(32))


def test_loader_transform_runs_on_worker_pool():
    src = _array_source(n=8)
    threads = set()

    def transform(x, y):
        threads.add(threading.get_ident())
        return x * 2.0, y + 100

    loader = data.DataLoader(src, batch_size=4, shuffle=False,
                             shard=data.ShardSpec(0, 1),
                             transform=transform, device_put=False,
                             num_workers=2, prefetch_depth=1)
    x, y = next(iter(loader))
    assert int(y[0]) == 100
    assert float(x[1, 0, 0, 0]) == 2.0
    assert threading.get_ident() not in threads
    loader._last.close()


def test_reiterating_loader_closes_abandoned_prefetcher():
    src = _array_source(n=32)
    loader = data.DataLoader(src, batch_size=4, shuffle=False,
                             shard=data.ShardSpec(0, 1), device="cpu",
                             num_workers=1, prefetch_depth=2)
    first = iter(loader)
    next(first)
    second = iter(loader)
    assert first._closed
    if first._thread is not None:
        first._thread.join(timeout=5)
        assert not first._thread.is_alive()
    assert len(list(second)) == 8
    loader._last.close()


def test_loader_epoch_reshuffle():
    src = _array_source(n=16)
    loader = data.DataLoader(src, batch_size=16, seed=2,
                             shard=data.ShardSpec(0, 1),
                             device_put=False, num_workers=0,
                             prefetch_depth=0)
    loader.set_epoch(0)
    _, y0 = next(iter(loader))
    loader.set_epoch(1)
    _, y1 = next(iter(loader))
    loader.set_epoch(0)
    _, y0b = next(iter(loader))
    assert not torch.equal(y0, y1)
    assert torch.equal(y0, y0b)


def test_make_loader_npy_normalizes_uint8(tmp_path):
    inputs = np.random.RandomState(4).randint(0, 256, (8, 4, 4, 3),
                                              dtype=np.uint8)
    inputs[:, 0, 0, 0] = 255
    labels = np.zeros(8, np.int32)
    data.write_npy_shards(str(tmp_path), inputs, labels)
    kw = dict(batch_size=4, device_put=False, prefetch_depth=0,
              num_workers=0)
    loader = data.make_loader("npy", str(tmp_path),
                              shard=data.ShardSpec(0, 1), **kw)
    x, _ = next(iter(loader))
    assert x.dtype == torch.float32 and float(x.max()) == 1.0
    ref = jdata.make_loader("npy", str(tmp_path),
                            shard=jdata.ShardSpec(0, 1), **kw)
    np.testing.assert_array_equal(x.numpy(), next(iter(ref))[0])


def test_loader_feeds_fit_epoch():
    """Loader batches drive the port's data-parallel step through
    ``training.fit_epoch`` at world 1 (gloo)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import MLP

    n, batch = 64, 16
    rng = np.random.RandomState(0)
    src = data.ArraySource(rng.randn(n, 12).astype(np.float32),
                           rng.randint(0, 4, size=(n,)).astype(np.int32))
    hvd.init(device="cpu")
    try:
        loader = data.DataLoader(src, batch_size=batch, device="cpu",
                                 shard=data.ShardSpec(0, 1),
                                 num_workers=2, prefetch_depth=2, seed=0)
        model = MLP(12, features=(16,), num_classes=4, device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        state = training.replicate_state(
            training.create_train_state(model, opt))
        step = training.data_parallel_train_step(model, opt)
        state, loss = training.fit_epoch(step, state, loader, epoch=0)
    finally:
        hvd.shutdown()
    assert loss is not None and np.isfinite(loss)
    assert state.step == len(loader)


# -- instrumentation ---------------------------------------------------------


def test_pipeline_metrics_reach_registry():
    before_wait = instr.DATA_HOST_WAIT.get()["count"]
    src = _array_source(n=16)
    loader = data.DataLoader(src, batch_size=4, shuffle=False,
                             shard=data.ShardSpec(0, 1), device="cpu",
                             num_workers=1, prefetch_depth=2)
    list(loader)
    assert instr.DATA_HOST_WAIT.get()["count"] >= before_wait + 4
    assert instr.DATA_BATCHES.labels(source="array").get() >= 4
    assert instr.DATA_BATCH_PRODUCE.get()["count"] >= 4
    assert instr.DATA_DEVICE_PUT.get()["count"] >= 4
    assert instr.DATA_PREFETCH_DEPTH.get() >= 0
    stats = loader.stats()
    for key in ("input_wait_ms_total", "host_produce_ms_mean",
                "device_put_ms_mean", "starved_batches"):
        assert key in stats


def test_pipeline_metric_names_match_reference():
    from horovod_tpu.metrics import instruments as jinstr

    for name in ("DATA_PREFETCH_DEPTH", "DATA_HOST_WAIT",
                 "DATA_BATCH_PRODUCE", "DATA_DEVICE_PUT", "DATA_BATCHES",
                 "STEP_DURATION", "CHAOS_INJECTIONS"):
        assert getattr(instr, name).name == getattr(jinstr, name).name


def test_chaos_drop_at_data_batch_surfaces_as_failure():
    from horovod_tpu_torch import chaos

    chaos.configure("data.batch:drop,at=1", seed=0)
    try:
        loader = data.DataLoader(_array_source(n=16), batch_size=4,
                                 shuffle=False, shard=data.ShardSpec(0, 1),
                                 device_put=False, num_workers=0,
                                 prefetch_depth=0)
        it = iter(loader)
        next(it)
        with pytest.raises(chaos.ChaosInjected, match="data.batch"):
            next(it)
    finally:
        chaos.clear()
