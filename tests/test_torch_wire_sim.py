"""The port's sim, wire framing and batch builders against the reference.

The same seed must give byte-identical records and frames, and decoding
must give equal arrays; a truncated or corrupted buffer must give the
same frames and ``consumed`` count, or the same ``FrameError`` reason.
"""

import numpy as np
import pytest

from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.sim import ParthaSim as TSim

SIM_KW = [dict(n_hosts=16, n_svcs=4, n_clients=256),
          dict(n_hosts=5, n_svcs=3, n_clients=64, seed=9, host_base=40,
               cli_groups_per_svc=2, zipf_a=1.1)]


@pytest.mark.parametrize("kw", SIM_KW)
def test_sim_records_byte_identical(kw):
    j, t = JSim(**kw), TSim(**kw)
    np.testing.assert_array_equal(t.glob_ids, j.glob_ids)
    for n in (64, 3000, 1):        # interleaved calls share one rng
        assert t.conn_records(n).tobytes() == j.conn_records(n).tobytes()
        assert t.resp_records(n).tobytes() == j.resp_records(n).tobytes()
    assert t.conn_frames(5000) == j.conn_frames(5000)
    assert t.resp_frames(9000) == j.resp_frames(9000)


def _stream():
    sim = JSim(**SIM_KW[0])
    return sim.conn_frames(2100) + sim.resp_frames(4200) + \
        sim.conn_frames(64)


def _same_frames(tf, jf):
    assert [s for s, _ in tf] == [s for s, _ in jf]
    for (_, a), (_, b) in zip(tf, jf):
        assert a.tobytes() == b.tobytes()


def test_decode_frames_and_batches_equal():
    buf = _stream()
    tf, tu = t_wire.decode_frames(buf)
    jf, ju = j_wire.decode_frames(buf)
    assert tu == ju == len(buf)
    _same_frames(tf, jf)
    for sub, recs in tf:
        if sub == t_wire.NOTIFY_TCP_CONN:
            got, ref = t_dec.conn_batch(recs, 2048), j_dec.conn_batch(recs,
                                                                      2048)
        else:
            got, ref = t_dec.resp_batch(recs, 4096), j_dec.resp_batch(recs,
                                                                      4096)
        assert got._fields == ref._fields
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        t_dec.conn_batch(tf[0][1], 16)


def test_to_device_stacks_and_carries_u32():
    recs = [TSim(**SIM_KW[0]).conn_records(8) for _ in range(3)]
    bs = [t_dec.conn_batch(r, 16) for r in recs]
    dev = t_dec.to_device(bs, "cpu")
    for name, col in zip(bs[0]._fields, dev):
        want = np.stack([getattr(b, name) for b in bs])
        assert tuple(col.shape) == (3, 16)
        np.testing.assert_array_equal(col.numpy(), want)
        if want.dtype == np.uint32:
            assert col.numpy().dtype == np.int64


@pytest.mark.parametrize("cut", [0, 5, 16, 23, 24, 1000, -1])
def test_truncated_buffer_same_prefix(cut):
    buf = _stream()
    part = buf[:cut] if cut >= 0 else buf[:-1]
    tf, tu = t_wire.decode_frames(part)
    jf, ju = j_wire.decode_frames(part)
    assert tu == ju
    _same_frames(tf, jf)


def _corrupt(kind):
    buf = bytearray(_stream())
    if kind == "magic":
        buf[0] ^= 0xFF
    elif kind == "payload":
        buf[200] ^= 0x10
    elif kind == "total_sz":
        buf[4:8] = (8).to_bytes(4, "little")
    elif kind == "nevents":
        # shrink nevents and fix the checksum: the frame no longer fills
        old = bytes(buf[16:24])
        buf[20:24] = (int.from_bytes(buf[20:24], "little") - 1).to_bytes(
            4, "little")
        x = t_wire._xor8(old) ^ t_wire._xor8(bytes(buf[16:24]))
        pad = int.from_bytes(buf[12:16], "little") ^ (x << 8)
        buf[12:16] = pad.to_bytes(4, "little")
    elif kind == "cap":
        recs = np.zeros(2049, t_wire.TCP_CONN_DT).tobytes()
        hdr = np.zeros((), t_wire.HEADER_DT)
        hdr["magic"] = t_wire.MAGIC_PM
        hdr["total_sz"] = 24 + len(recs)
        hdr["data_type"] = t_wire.COMM_EVENT_NOTIFY
        ev = np.zeros((), t_wire.EVENT_NOTIFY_DT)
        ev["subtype"], ev["nevents"] = t_wire.NOTIFY_TCP_CONN, 2049
        return hdr.tobytes() + ev.tobytes() + recs
    return bytes(buf)


@pytest.mark.parametrize("kind", ["magic", "payload", "total_sz", "nevents",
                                  "cap"])
def test_corrupt_buffer_same_frame_error(kind):
    buf = _corrupt(kind)
    with pytest.raises(j_wire.FrameError) as je:
        j_wire.decode_frames(buf)
    with pytest.raises(t_wire.FrameError) as te:
        t_wire.decode_frames(buf)
    assert te.value.reason == je.value.reason


def test_unknown_subtype_counted_and_event_only():
    recs = np.zeros(3, t_wire.RESP_SAMPLE_DT)
    frame = bytearray(t_wire.encode_frame(t_wire.NOTIFY_RESP_SAMPLE, recs))
    frame[16:20] = (200).to_bytes(4, "little")     # unknown subtype, no CHK
    frame[12:16] = (0).to_bytes(4, "little")
    buf = bytes(frame) + t_wire.encode_frame(t_wire.NOTIFY_RESP_SAMPLE, recs)
    tc, jc = {}, {}
    tf, tu = t_wire.decode_frames(buf, tc)
    jf, ju = j_wire.decode_frames(buf, jc)
    assert tc == jc == {"unknown_records": 3} and tu == ju
    _same_frames(tf, jf)
    ctrl = bytearray(frame)
    ctrl[8:12] = (2).to_bytes(4, "little")         # a non-EVENT data_type
    for w in (t_wire, j_wire):
        with pytest.raises(w.FrameError) as e:
            w.decode_frames(bytes(ctrl), event_only=True)
        assert e.value.reason == "bad_dtype"
    with pytest.raises(t_wire.FrameError):
        t_wire.encode_frame(t_wire.NOTIFY_TCP_CONN,
                            np.zeros(2049, t_wire.TCP_CONN_DT))
