"""The port's sweep-section streams and batch builders against the
reference: the same seed gives byte-identical records and frames for
every record type ``fold_all``'s sweep sections fold, decoding gives
equal frames, and each columnar builder gives equal arrays."""

import numpy as np
import pytest
import torch

from gyeeta_tpu.ingest import decode as j_dec, wire as j_wire
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.ingest import decode as t_dec, wire as t_wire
from gyeeta_tpu_torch.sim import ParthaSim as TSim

SIM_KW = [dict(n_hosts=8, n_svcs=4, n_clients=256),
          dict(n_hosts=5, n_svcs=3, n_clients=64, seed=9, host_base=40,
               n_groups=4, cli_groups_per_svc=2)]

# (name, sim call) — each draws from the sim's one rng, so the calls run
# in this order on both sims
_STREAMS = [
    ("listener_frames", lambda s: s.listener_frames()),
    ("task_frames", lambda s: s.task_frames()),
    ("svc_conn", lambda s: s.svc_conn_records(70).tobytes()),
    ("svc_conn_split", lambda s: b"".join(
        r.tobytes() for r in s.svc_conn_records(50, split_halves=True))),
    ("svc_conn_nat", lambda s: s.svc_conn_records(33, nat=True).tobytes()),
    ("trace_frames", lambda s: s.trace_frames(300)),
    ("trace_frames_only_svcs", lambda s: s.trace_frames(
        500, only_svcs=list(s.glob_ids.reshape(-1)[::2]))),
    ("cpu_mem", lambda s: s.cpu_mem_records(hot_cpu=[1],
                                            hot_mem=[2]).tobytes()),
    ("host_state", lambda s: s.host_state_records().tobytes()),
    ("conn_after", lambda s: s.conn_records(40).tobytes()),
]


@pytest.mark.parametrize("kw", SIM_KW, ids=["default", "host_base40"])
def test_sim_sweep_streams_byte_identical(kw):
    j, t = JSim(**kw), TSim(**kw)
    np.testing.assert_array_equal(t.task_ids, j.task_ids)
    np.testing.assert_array_equal(t.comm_ids, j.comm_ids)
    assert t.API_SIGS == j.API_SIGS
    for a, b in zip(t.svc_call_graph(), j.svc_call_graph()):
        np.testing.assert_array_equal(a, b)
    for name, call in _STREAMS:
        assert call(t) == call(j), name


def _sweep_frames(sim, wire):
    """One of each sweep record type, framed, with keepalive pings."""
    tasks = sim.aggr_task_records()
    pings = np.zeros(len(tasks) // 2, wire.TASK_PING_DT)
    pings["aggr_task_id"] = tasks["aggr_task_id"][::2]
    pings["host_id"] = tasks["host_id"][::2]
    return b"".join((
        sim.listener_frames(),
        wire.encode_frames_chunked(wire.NOTIFY_AGGR_TASK_STATE, tasks),
        wire.encode_frames_chunked(wire.NOTIFY_HOST_STATE,
                                   sim.host_state_records()),
        wire.encode_frames_chunked(wire.NOTIFY_CPU_MEM_STATE,
                                   sim.cpu_mem_records(hot_cpu=[0])),
        sim.trace_frames(200),
        wire.encode_frames_chunked(wire.NOTIFY_TASK_PING, pings),
    ))


def _frames():
    return _sweep_frames(JSim(**SIM_KW[0]), j_wire)


def test_sweep_frames_decode_equal():
    buf = _frames()
    assert _sweep_frames(TSim(**SIM_KW[0]), t_wire) == buf
    tf, tu = t_wire.decode_frames(buf)
    jf, ju = j_wire.decode_frames(buf)
    assert tu == ju == len(buf)
    assert [s for s, _ in tf] == [s for s, _ in jf] == [
        t_wire.NOTIFY_LISTENER_STATE, t_wire.NOTIFY_AGGR_TASK_STATE,
        t_wire.NOTIFY_HOST_STATE, t_wire.NOTIFY_CPU_MEM_STATE,
        t_wire.NOTIFY_REQ_TRACE, t_wire.NOTIFY_TASK_PING]
    for (_, a), (_, b) in zip(tf, jf):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


_BUILDERS = [
    (t_wire.NOTIFY_LISTENER_STATE, "listener_batch", 48),
    (t_wire.NOTIFY_AGGR_TASK_STATE, "task_batch", 80),
    (t_wire.NOTIFY_HOST_STATE, "host_batch", 16),
    (t_wire.NOTIFY_CPU_MEM_STATE, "cpumem_batch", 12),
    (t_wire.NOTIFY_REQ_TRACE, "trace_batch", 256),
    (t_wire.NOTIFY_TASK_PING, "ping_batch", 40),
]


@pytest.mark.parametrize("sub,builder,size", _BUILDERS,
                         ids=[b for _, b, _ in _BUILDERS])
def test_batch_builder_equal(sub, builder, size):
    frames, _ = t_wire.decode_frames(_frames())
    recs, = [r for s, r in frames if s == sub]
    got = getattr(t_dec, builder)(recs, size)
    ref = getattr(j_dec, builder)(recs, size)
    assert got._fields == ref._fields
    assert int(got.valid.sum()) == len(recs) < size
    for name, a, b in zip(got._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError, match="exceed batch size"):
        getattr(t_dec, builder)(recs, len(recs) - 1)


def test_column_constants_match():
    for name in dir(j_dec):
        if name.startswith(("STAT_", "TASK_", "HOST_", "CM_")) or \
                name in ("NSTAT", "NTASKSTAT", "NHOSTCOL", "NCM"):
            if isinstance(getattr(j_dec, name), int):
                assert getattr(t_dec, name) == getattr(j_dec, name), name
    for sub, dt in t_wire.DTYPE_OF_SUBTYPE.items():
        assert j_wire.DTYPE_OF_SUBTYPE[sub] == dt
        assert j_wire.MAX_OF_SUBTYPE[sub] == t_wire.MAX_OF_SUBTYPE[sub]


def test_sweep_caps_enforced():
    with pytest.raises(t_wire.FrameError):
        t_wire.encode_frame(t_wire.NOTIFY_AGGR_TASK_STATE,
                            np.zeros(1201, t_wire.AGGR_TASK_DT))
    big = np.zeros(1201, t_wire.AGGR_TASK_DT)
    assert t_wire.encode_frames_chunked(t_wire.NOTIFY_AGGR_TASK_STATE,
                                        big) == \
        j_wire.encode_frames_chunked(j_wire.NOTIFY_AGGR_TASK_STATE, big)


def test_to_device_sweep_batches():
    frames, _ = t_wire.decode_frames(_frames())
    recs, = [r for s, r in frames if s == t_wire.NOTIFY_REQ_TRACE]
    tb = t_dec.trace_batch(recs, 256)
    one = t_dec.to_device(tb, "cpu")
    two = t_dec.to_device([tb, tb], "cpu")
    for name, a, d1, d2 in zip(tb._fields, tb, one, two):
        want = a.astype(np.int64) if a.dtype == np.uint32 else a
        assert d2.shape == (2,) + a.shape, name
        np.testing.assert_array_equal(d1.numpy(), want, err_msg=name)
        np.testing.assert_array_equal(d2[1].numpy(), want, err_msg=name)
    assert one.key_hi.dtype == torch.int64 and one.is_err.dtype == torch.bool
