"""Fault injection into repro_torch's hardened stream readers (marker:
faultinject), held against repro's under the same schedules: transient
errors are absorbed and counted alike, corruption and truncation are loud
`StreamFormatError`s — never a wrongly partitioned graph — and a
checkpointed run over a faulty stream still resumes bit-identically."""
import errno
import shutil

import numpy as np
import pytest

import repro.graphs as R
import repro_torch.core.checkpoint as ckmod
from repro_torch.convert import graph_from_numpy
from repro_torch.core import BuffCutConfig, MultilevelConfig, buffcut_partition
from repro_torch.core.checkpoint import Checkpointer, load_checkpoint
from repro_torch.graphs import (
    DiskNodeStream,
    FaultSchedule,
    FaultyOpener,
    StreamFormatError,
    write_metis,
    write_packed,
)
from repro_torch.graphs.stream_io import RetryPolicy, read_packed_header

pytestmark = pytest.mark.faultinject

_FAST = RetryPolicy(retries=3, backoff_s=0.0005)


def _cfg(engine="sparse"):
    return BuffCutConfig(k=8, buffer_size=64, batch_size=16, eps=0.1,
                         ml=MultilevelConfig(engine=engine, device="cpu"))


@pytest.fixture(scope="module")
def graph():
    g = R.rmat_graph(200, 6, seed=9)  # rounds up to n=256
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


@pytest.fixture(scope="module")
def packed_file(graph, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("torch-faults") / "g.bcsr")
    write_packed(graph, p)
    return p


@pytest.fixture(scope="module")
def metis_file(graph, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("torch-faults") / "g.metis")
    write_metis(graph, p)
    return p


def _drain(stream):
    return [(v, nbrs.copy(), w.copy(), nw) for v, nbrs, w, nw in stream]


def _assert_same_records(a, b):
    assert len(a) == len(b)
    for (va, na, wa, nwa), (vb, nb_, wb, nwb) in zip(a, b):
        assert va == vb and nwa == nwb
        np.testing.assert_array_equal(na, nb_)
        np.testing.assert_array_equal(wa, wb)


def _ref_faulty(path, sched):
    from repro.graphs.faults import FaultyOpener as RefFaultyOpener
    from repro.graphs.stream_io import RetryPolicy as RefRetryPolicy

    return R.DiskNodeStream(path, 512, opener=RefFaultyOpener(sched),
                            retry=RefRetryPolicy(retries=3, backoff_s=0.0005))


def _both_schedules(**kw):
    from repro.graphs.faults import FaultSchedule as RefFaultSchedule

    return FaultSchedule(**kw), RefFaultSchedule(**kw)


@pytest.mark.parametrize("fmt", ["packed", "metis"])
def test_transient_read_errors_are_absorbed_and_counted_like_the_reference(
        fmt, packed_file, metis_file):
    path = packed_file if fmt == "packed" else metis_file
    clean = _drain(DiskNodeStream(path, 512))
    sched, ref_sched = _both_schedules(transient_reads={1, 4, 7})
    faulty = DiskNodeStream(path, 512, opener=FaultyOpener(sched), retry=_FAST)
    _assert_same_records(_drain(faulty), clean)
    assert sched.injected["transient_read"] >= 1
    assert faulty.io_retries >= sched.injected["transient_read"]
    ref = _ref_faulty(path, ref_sched)
    _assert_same_records(_drain(ref), clean)
    assert faulty.io_retries == ref.io_retries
    assert dict(sched.injected) == dict(ref_sched.injected)


def test_transient_open_errors_are_absorbed(packed_file):
    clean = _drain(DiskNodeStream(packed_file, 512))
    sched = FaultSchedule(fail_opens={0, 2})
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    _assert_same_records(_drain(faulty), clean)
    assert sched.injected["failed_open"] == 2


@pytest.mark.parametrize("fmt", ["packed", "metis"])
def test_short_reads_are_transparent(fmt, packed_file, metis_file):
    path = packed_file if fmt == "packed" else metis_file
    clean = _drain(DiskNodeStream(path, 512))
    sched = FaultSchedule(short_reads={0, 1, 2, 3})
    faulty = DiskNodeStream(path, 512, opener=FaultyOpener(sched), retry=_FAST)
    _assert_same_records(_drain(faulty), clean)
    assert sched.injected["short_read"] >= 1


def test_retry_exhaustion_propagates_the_error(packed_file):
    sched = FaultSchedule(transient_reads=set(range(1, 30)))
    with pytest.raises(OSError):
        _drain(DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST))


def test_permanent_errors_never_retry(tmp_path):
    with pytest.raises(FileNotFoundError):
        DiskNodeStream(str(tmp_path / "missing.bcsr"), retry=_FAST)


def test_corrupted_packed_section_is_a_stream_format_error(packed_file):
    assert DiskNodeStream(packed_file, 512).crc_protected
    hits = 0
    for read_idx in (1, 2, 3):
        for at in (7, 512, 4000):
            sched = FaultSchedule(corrupt_reads={read_idx}, corrupt_byte=at)
            try:
                _drain(DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched),
                                      retry=_FAST))
            except StreamFormatError:
                hits += 1
            else:
                assert sched.injected["corrupt_read"] >= 1
    assert hits >= 3, "section CRC never fired on payload corruption"


def test_truncated_packed_tail_is_a_stream_format_error(packed_file):
    sched = FaultSchedule(truncate_after=4096)
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    with pytest.raises(StreamFormatError):
        _drain(faulty)
    assert sched.injected["truncated_read"] >= 1


@pytest.mark.parametrize("engine", ["sparse", "torch"])
def test_driver_absorbs_transient_faults_bit_identically(engine, packed_file):
    cfg = _cfg(engine)
    clean_labels, clean_stats = buffcut_partition(DiskNodeStream(packed_file, 512), cfg)
    sched = FaultSchedule(transient_reads={2, 5})
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    labels, stats = buffcut_partition(faulty, cfg)
    np.testing.assert_array_equal(labels, clean_labels)
    assert stats.cut_weight == clean_stats.cut_weight
    assert stats.io_retries >= 1 and clean_stats.io_retries == 0


def test_driver_never_partitions_corrupted_data(packed_file):
    # read 3 is the first data-section chunk (0 = magic, 1-2 = header reads)
    sched = FaultSchedule(corrupt_reads={3}, corrupt_byte=100)
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    with pytest.raises(StreamFormatError):
        buffcut_partition(faulty, _cfg())
    assert sched.injected["corrupt_read"] == 1


def test_checkpointed_run_with_faults_still_resumes(packed_file, tmp_path, monkeypatch):
    cfg = _cfg()
    base, _ = buffcut_partition(DiskNodeStream(packed_file, 512), cfg)
    real = ckmod.save_checkpoint
    snap = str(tmp_path / "snap.ckpt")
    count = [0]

    def tee(path, state):
        real(path, state)
        count[0] += 1
        if count[0] == 2:
            shutil.copy(path, snap)

    monkeypatch.setattr(ckmod, "save_checkpoint", tee)
    sched = FaultSchedule(transient_reads={3, 9})
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    labels, _ = buffcut_partition(faulty, cfg, ckpt=Checkpointer(str(tmp_path / "c"), every=2))
    np.testing.assert_array_equal(labels, base)
    assert count[0] >= 2
    monkeypatch.undo()
    st = load_checkpoint(snap)
    faulty2 = DiskNodeStream(packed_file, 512, opener=FaultyOpener(
        FaultSchedule(transient_reads={1})), retry=_FAST)
    labels2, stats2 = buffcut_partition(faulty2, cfg, resume=st)
    np.testing.assert_array_equal(labels2, base)
    # retries accumulate across the resume boundary
    assert stats2.io_retries >= int(st["stats"]["io_retries"]) + 1


def test_header_crc_catches_on_disk_corruption(graph, tmp_path):
    p = str(tmp_path / "g.bcsr")
    write_packed(graph, p)
    raw = bytearray(open(p, "rb").read())
    raw[40] ^= 0x01
    open(p, "wb").write(bytes(raw))
    with pytest.raises(StreamFormatError, match="header CRC"):
        read_packed_header(p)
    with pytest.raises(StreamFormatError, match="header CRC"):
        DiskNodeStream(p)


@pytest.mark.parametrize("code", [errno.EIO, errno.EAGAIN, errno.EINTR])
def test_errno_variants_all_retry(code, packed_file):
    clean = _drain(DiskNodeStream(packed_file, 512))
    sched = FaultSchedule(transient_reads={2}, errno_code=code)
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    _assert_same_records(_drain(faulty), clean)
    assert faulty.io_retries == 1


def test_prefetched_stream_reraises_the_fault_in_the_consumer(packed_file):
    sched = FaultSchedule(corrupt_reads={3}, corrupt_byte=100)
    faulty = DiskNodeStream(packed_file, 512, opener=FaultyOpener(sched), retry=_FAST)
    with pytest.raises(StreamFormatError):
        buffcut_partition(faulty, _cfg(), prefetch_batches=2)
