"""PyTorch port, time-varying volumes: the port's ``volume/timevary.py``
against the JAX package's, on the CPU. Both are numpy, so the fields are
held bitwise equal; a stream dumped by either package reads back through the
other's ``DiskStream``."""
import numpy as np
import pytest

from repro.volume import timevary as JT
from repro_torch.volume import timevary as TT
from repro_torch.volume import CallbackStream, VolumeSpec, VolumeStream

RES = 20


@pytest.mark.parametrize("name", ["kingsnake", "miranda"])
def test_generators_bitwise_equal_to_jax(name):
    for t in (0.0, 0.35, 1.0):
        want = JT.GENERATORS[name](t, res=RES)
        got = TT.GENERATORS[name](t, res=RES)
        assert isinstance(got, VolumeSpec)
        assert got.field.dtype == want.field.dtype == np.float32
        np.testing.assert_array_equal(got.field, want.field)
        assert (got.isovalue, got.extent, got.name) == (want.isovalue, want.extent, want.name)


def test_synthetic_stream_keeps_order_and_names():
    want = JT.synthetic_stream("miranda", 4, res=RES, t0=0.05, t1=0.3)
    got = TT.synthetic_stream("miranda", 4, res=RES, t0=0.05, t1=0.3)
    assert isinstance(got, CallbackStream) and isinstance(got, VolumeStream)
    assert len(got) == len(want) == 4 and got.name == want.name and got.times == want.times
    vols = list(got)
    assert [v.name for v in vols] == [v.name for v in want]
    assert [v.name for v in got] == [v.name for v in vols]  # a source, consumed again
    for a, b in zip(vols, want):
        np.testing.assert_array_equal(a.field, b.field)
    assert set(TT.GENERATORS) == set(JT.GENERATORS)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_stream_reads_the_other_packages_dump(tmp_path, writer):
    dump, read = (JT, TT) if writer == "jax" else (TT, JT)
    stream = dump.synthetic_stream("kingsnake", 3, res=RES, t1=0.2)
    paths = dump.dump_stream(stream, str(tmp_path))
    assert len(paths) == 3
    disk = read.DiskStream(str(tmp_path))
    assert disk.name == "kingsnake" and len(disk) == 3
    for mem, post in zip(stream, disk):
        np.testing.assert_array_equal(post.field, mem.field)
        assert (post.isovalue, post.extent, post.name) == (mem.isovalue, mem.extent, mem.name)
