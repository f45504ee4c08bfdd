"""The PyTorch port's image input pipeline (``data/arrays.py``, the image
half of ``data/loader.py``) against the JAX package's: the same files on
disk, byte-identical batches at the same steps and shards, and the union
of the shards' rows is the global batch."""

import os

import numpy as np
import pytest

from container_engine_accelerators_tpu.data import arrays as jarrays
from container_engine_accelerators_tpu.data import loader as jloader
from container_engine_accelerators_tpu_torch.data import (
    ArrayShardReader,
    ImageBatchLoader,
    write_array_shards,
)


def _shards(dtype=np.uint8, seed=0, sizes=(7, 5, 9), shape=(4, 4, 3),
            classes=10):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if dtype == np.uint8:
            images = rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
        else:
            images = rng.standard_normal((n,) + shape).astype(dtype)
        out.append((images, rng.integers(0, classes, n).astype(np.int32)))
    return out


def test_writers_write_the_same_files(tmp_path):
    batches = _shards()
    port = write_array_shards(str(tmp_path / "port"), batches)
    ref = jarrays.write_array_shards(str(tmp_path / "jax"), batches)
    assert [os.path.basename(p) for p in port] == [
        os.path.basename(p) for p in ref]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_reader_reads_jax_shards_modularly(tmp_path, dtype):
    jarrays.write_array_shards(str(tmp_path), _shards(dtype))
    port, ref = ArrayShardReader(str(tmp_path)), jarrays.ArrayShardReader(
        str(tmp_path))
    assert port.total_samples == ref.total_samples == 21
    assert port.sample_shape == ref.sample_shape == (4, 4, 3)
    for start, n in ((0, 21), (5, 9), (19, 30), (44, 3)):
        for a, b in zip(port.read(start, n), ref.read(start, n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_writer_refuses_a_directory_that_holds_shards(tmp_path):
    jarrays.write_array_shards(str(tmp_path), _shards())
    with pytest.raises(ValueError, match="refusing to mix"):
        write_array_shards(str(tmp_path), _shards(seed=1))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_loader_batches_equal_the_jax_loaders(tmp_path, dtype, shard):
    jarrays.write_array_shards(str(tmp_path), _shards(dtype))
    port = ImageBatchLoader(ArrayShardReader(str(tmp_path)), 6,
                            num_classes=10, shard=shard)
    ref = jloader.ImageBatchLoader(jarrays.ArrayShardReader(str(tmp_path)),
                                   6, num_classes=10, shard=shard)
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 3
    it = port.iter_batches(2, 4)
    try:
        for step, got in zip(range(2, 6), it):
            for a, b, c in zip(got, port.batch_at(step), ref.batch_at(step)):
                assert a.dtype == c.dtype and a.tobytes() == c.tobytes()
                assert b.tobytes() == c.tobytes()
    finally:
        it.close()
    images, _ = port.batch_at(0)
    assert images.dtype == np.float32 and images.shape == (
        6 // shard[1], 4, 4, 3)
    if dtype == np.uint8:
        assert 0.0 <= images.min() and images.max() <= 1.0


def test_the_shards_rows_make_the_global_batch(tmp_path):
    jarrays.write_array_shards(str(tmp_path), _shards())
    reader = ArrayShardReader(str(tmp_path))
    whole = ImageBatchLoader(reader, 6)
    for step in range(4):
        parts = [ImageBatchLoader(reader, 6, shard=(pid, 3)).batch_at(step)
                 for pid in range(3)]
        for i, want in enumerate(whole.batch_at(step)):
            assert np.array_equal(np.concatenate([p[i] for p in parts]),
                                  want)


def test_labels_past_num_classes_raise(tmp_path):
    jarrays.write_array_shards(str(tmp_path), _shards(classes=10))
    loader = ImageBatchLoader(ArrayShardReader(str(tmp_path)), 21,
                              num_classes=5)
    with pytest.raises(ValueError, match="num_classes 5"):
        loader.batch_at(0)
    it = loader.iter_batches(0, 2)
    with pytest.raises(ValueError, match="num_classes 5"):
        next(it)
    it.close()


@pytest.mark.parametrize("batch,shard", [(0, (0, 1)), (6, (2, 2)),
                                         (6, (0, 4)), (6, (0, 0))])
def test_bad_batch_or_shard_raises(tmp_path, batch, shard):
    jarrays.write_array_shards(str(tmp_path), _shards())
    with pytest.raises(ValueError):
        ImageBatchLoader(ArrayShardReader(str(tmp_path)), batch, shard=shard)
