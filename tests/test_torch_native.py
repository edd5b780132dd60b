"""The port's native deframer and columnar decoder against the reference.

``gyeeta_tpu_torch/ingest/native`` (its own copy of ``deframe.cpp``,
built with ``g++`` into ``build/native/``) is held bit for bit against
the reference's native path (``gyeeta_tpu.ingest.native``) and its
Python path, and against the port's numpy path: ``drain2`` on
``ParthaSim`` streams, partial frames, the bad frames of
``tests/test_native_ingest.py`` (the same ``FrameError.reason``) and a
seeded fuzz of mixed streams; each columnar decoder (conn with NAT
tuples, resp, the four sweep packs, ping, the chunked slab assembly and
the int64-carrier staging decode). A port ``Runtime`` with
``deframe="native"`` and one with ``deframe="python"`` fed the stream of
``tests/test_torch_runtime.py`` give equal state and dependency-graph
leaves and equal counters (the decode-path pair swapped).
"""

import functools

import numpy as np
import pytest

from gyeeta_tpu.ingest import decode as j_dec, native as j_nat
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.sim.partha import ParthaSim as JSim
from gyeeta_tpu_torch.engine import aggstate as t_agg
from gyeeta_tpu_torch.ingest import decode as t_dec, native as t_nat
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.ingest.native import build as t_build
from gyeeta_tpu_torch.parallel import depgraph as t_dg
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats
from gyeeta_tpu_torch.utils.tensor import tree_leaves, tree_paths
from test_torch_runtime import OPTS, t_cfg, tick_buffers

pytestmark = pytest.mark.skipif(not j_nat.available(),
                                reason="the reference's native library "
                                "is not built (g++ missing)")


def mixed_stream(seed=7, n_conn=3000, n_resp=9000):
    sim = JSim(n_hosts=8, n_svcs=4, seed=seed)
    return (sim.conn_frames(n_conn) + sim.resp_frames(n_resp)
            + sim.listener_frames() + sim.task_frames()
            + sim.trace_frames(200) + sim.name_frames()
            + j_wire.encode_frame(j_wire.NOTIFY_HOST_STATE,
                                  sim.host_state_records()))


def _outcome(fn, buf):
    """drain2 → ("ok", {subtype: bytes}, consumed, unknown) or
    ("err", reason)."""
    try:
        recs, consumed, unknown = fn(buf)
    except (j_wire.FrameError, t_wire.FrameError) as e:
        return ("err", e.reason)
    return ("ok", {k: v.tobytes() for k, v in recs.items()}, consumed,
            unknown)


_DRAINS = {"ref_native": j_nat.drain2, "ref_python": j_nat._drain_py2,
           "port_native": t_nat.drain2, "port_python": t_wire.drain2}


def test_library_builds_under_build_native():
    path = t_build.build()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build" and path.exists()
    assert t_build.build() == path          # cached by source hash


def _unknown_plus_known():
    known = j_wire.encode_frame(j_wire.NOTIFY_RESP_SAMPLE,
                                np.zeros(5, j_wire.RESP_SAMPLE_DT))
    return j_wire.encode_frame(777, np.zeros(3, j_wire.RESP_SAMPLE_DT)) \
        + known


STREAMS = {
    "mixed": lambda: mixed_stream(),
    "partial": lambda: mixed_stream(n_conn=100, n_resp=0)[:-33],
    "header_only_tail": lambda: mixed_stream(n_conn=10, n_resp=10)[:-1000],
    "empty": lambda: b"",
    "unknown_subtype": _unknown_plus_known,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_drain2_matches_reference(name):
    buf = STREAMS[name]()
    ref = _outcome(j_nat.drain2, buf)
    assert ref[0] == "ok"
    for which, fn in _DRAINS.items():
        assert _outcome(fn, buf) == ref, which


def _poison(kind):
    frame = bytearray(mixed_stream(n_conn=10, n_resp=0))
    if kind == "bad_magic":
        frame[0] ^= 0x5A
    elif kind == "bad_total_small":
        frame[4:8] = (4).to_bytes(4, "little")
    elif kind == "bad_total_big":
        frame[4:8] = (2 ** 25).to_bytes(4, "little")
    elif kind == "cap_exceeded":
        frame[20:24] = (j_wire.MAX_OF_SUBTYPE[j_wire.NOTIFY_TCP_CONN]
                        + 1).to_bytes(4, "little")
    elif kind == "nevents_overflow":
        frame[20:24] = (18).to_bytes(4, "little")
    elif kind == "checksum":
        frame[40] ^= 0x01
    elif kind == "bad_dtype":
        frame[8:12] = (2).to_bytes(4, "little")
    return bytes(frame)


@pytest.mark.parametrize("kind", ["bad_magic", "bad_total_small",
                                  "bad_total_big", "cap_exceeded",
                                  "nevents_overflow", "checksum",
                                  "bad_dtype"])
def test_bad_frame_raises_the_same_reason(kind):
    buf = _poison(kind)
    ref = _outcome(j_nat.drain2, buf)
    assert ref[0] == "err"
    assert _outcome(t_nat.drain2, buf) == ref
    # the port's own Python drain rejects it too
    assert _outcome(t_wire.drain2, buf)[0] == "err"


def _rand_records(rng, dt, n):
    nwords = max(n * dt.itemsize // 8, 1)
    return np.frombuffer(
        rng.integers(0, 2 ** 63, nwords, dtype=np.int64).tobytes(),
        dt, count=n)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_streams_match_reference(seed):
    """Randomized mixed-subtype streams with truncated tails, poison
    frames and unknown subtypes: the port's native drain gives the
    reference's native outcome, trial by trial."""
    rng = np.random.default_rng(20261017 + seed)
    subtypes = sorted(j_wire.DTYPE_OF_SUBTYPE)
    n_err = 0
    for trial in range(100):
        parts = []
        for _ in range(int(rng.integers(1, 6))):
            st = int(rng.choice(subtypes))
            nev = int(rng.integers(0, 17))
            frame = bytearray(j_wire.encode_frame(st, _rand_records(
                rng, j_wire.DTYPE_OF_SUBTYPE[st], nev)))
            p = rng.random()
            if p < 0.04:
                frame[0] ^= 0x5A
            elif p < 0.08:
                frame[4:8] = int(rng.choice([4, 2 ** 25])).to_bytes(
                    4, "little")
            elif p < 0.12:
                frame[20:24] = (j_wire.MAX_OF_SUBTYPE[st] + 1).to_bytes(
                    4, "little")
            elif p < 0.16:
                frame[20:24] = (nev + 8).to_bytes(4, "little")
            elif p < 0.22:
                frame[16:20] = int(rng.integers(500, 1000)).to_bytes(
                    4, "little")
            parts.append(bytes(frame))
        buf = b"".join(parts)
        if rng.random() < 0.25 and len(buf) > 4:
            buf = buf[: len(buf) - int(rng.integers(1, len(parts[-1])))]
        ref = _outcome(j_nat.drain2, buf)
        assert _outcome(t_nat.drain2, buf) == ref, trial
        n_err += ref[0] == "err"
    assert n_err > 5


def _conn_recs():
    sim = JSim(n_hosts=8, n_svcs=4, seed=77)
    cli, ser = sim.svc_conn_records(64, split_halves=True)
    recs = np.concatenate([sim.conn_records(512), cli, ser])
    rng = np.random.default_rng(5)
    for side in ("nat_cli", "nat_ser"):
        rows = rng.choice(len(recs), 100, replace=False)
        recs[side]["ip"][rows, :4] = rng.integers(1, 255, (100, 4),
                                                  dtype=np.uint8)
        recs[side]["port"][rows] = rng.integers(1024, 65535, 100,
                                                dtype=np.uint16)
    return recs


def _assert_batch_bytes(ref, got, msg=""):
    assert got._fields == ref._fields
    for f, a, b in zip(ref._fields, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, f)
        assert a.tobytes() == b.tobytes(), (msg, f)


def test_conn_decode_matches_reference():
    recs = _conn_recs()
    ref = j_nat.decode_conn(recs, 1024)
    _assert_batch_bytes(ref, t_dec.conn_batch_parts([recs], 1024))
    _assert_batch_bytes(ref, t_dec.conn_batch_parts([recs], 1024,
                                                    native=False))
    _assert_batch_bytes(j_dec.conn_batch(recs, 1024), ref, "ref python")


def test_resp_decode_matches_reference():
    recs = JSim(n_hosts=8, n_svcs=4, seed=21).resp_records(3000)
    ref = j_dec.resp_batch_fast(recs, 4096)
    _assert_batch_bytes(ref, t_dec.resp_batch_parts([recs], 4096))
    _assert_batch_bytes(ref, t_dec.resp_batch_parts([recs], 4096,
                                                    native=False))


@pytest.mark.parametrize("fast,dt", [
    ("listener_batch_fast", "LISTENER_STATE_DT"),
    ("host_batch_fast", "HOST_STATE_DT"),
    ("task_batch_fast", "AGGR_TASK_DT"),
    ("cpumem_batch_fast", "CPU_MEM_DT"),
    ("ping_batch", "TASK_PING_DT"),
])
def test_sweep_decode_matches_reference(fast, dt):
    """Random bits (NaN patterns included) through the generic pack
    kernels: bytes equal to the reference's native builder, and to the
    port's numpy path."""
    rng = np.random.default_rng(abs(hash(fast)) % 2 ** 31)
    recs = _rand_records(rng, getattr(j_wire, dt), 40)
    ref = getattr(j_dec, fast)(recs, 64)
    _assert_batch_bytes(ref, getattr(t_dec, fast)(recs, 64))
    _assert_batch_bytes(ref, getattr(t_dec, fast)(recs, 64, native=False))


def test_staging_decode_into_int64_carriers():
    """The runtime's staging slabs hold each u32 column in an int64
    carrier: a native decode into a reused buffer gives the reference's
    values, lanes past the fill zeroed."""
    recs = _conn_recs()
    resp = JSim(n_hosts=8, n_svcs=4, seed=3).resp_records(700)
    cb, rb = t_dec.alloc_conn_cols(1024), t_dec.alloc_resp_cols(1024)
    t_dec.conn_slab([recs[:600]], 2, 512, out=cb)
    t_dec.resp_slab([resp], 2, 512, out=rb)
    chunks = [recs[:100], recs[100:300], recs[300:]]
    got = t_dec.conn_slab(chunks, 2, 512, out=cb, clear_to=600)
    gotr = t_dec.resp_slab([resp[:1], resp[1:200]], 2, 512, out=rb,
                           clear_to=700)
    ref = j_dec.conn_slab(chunks, 2, 512)
    refr = j_dec.resp_slab([resp[:200]], 2, 512)
    for f, a, b in zip(ref._fields, ref, got):
        assert b.dtype == (np.int64 if a.dtype == np.uint32 else a.dtype)
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)
    for f, a, b in zip(refr._fields, refr, gotr):
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f)


def test_native_path_counters():
    st, py = Stats(), Stats()
    sim = TSim(n_hosts=4, n_svcs=2, seed=6)
    t_dec.conn_slab(sim.conn_records(64), 1, 128, stats=st)
    t_dec.listener_batch_fast(sim.listener_state_records(), 64, stats=st)
    t_dec.conn_slab(sim.conn_records(64), 1, 128, stats=py, native=False)
    assert st.counters["ref_native_decoded"] >= 64
    assert "ref_fallback_decoded" not in st.counters
    assert py.counters == {"ref_fallback_decoded": 64}


def test_runtime_rejects_unknown_deframe():
    with pytest.raises(ValueError, match="deframe"):
        TRuntime(t_cfg(), TOpts(**OPTS), device="cpu", deframe="numpy")


def _leaves(tree, arrays) -> dict:
    """Leaf path → numpy array (``arrays``: the tree's leaves as numpy,
    in ``tree_leaves`` order)."""
    names = tree_paths(tree)
    assert len(names) == len(arrays) == len(tree_leaves(tree))
    return dict(zip(names, arrays))


@functools.lru_cache(maxsize=None)
def _native_vs_python():
    bufs = tick_buffers(TSim, t_wire)
    out = {}
    for path in ("native", "python"):
        now = [1.7e9]
        rt = TRuntime(t_cfg(), TOpts(**OPTS), clock=lambda: now[0],
                      device="cpu", deframe=path)
        try:
            reports = []
            for buf in bufs:
                for a, b in ((0, len(buf) - 5000), (len(buf) - 5000,
                                                    len(buf))):
                    rt.feed(buf[a:b])
                now[0] += 5.0
                reports.append(rt.run_tick())
            out[path] = dict(
                reports=reports, ctr=dict(rt.stats.counters),
                state=_leaves(rt.state, t_agg.state_to_numpy(rt.state)),
                dep=_leaves(rt.dep, t_dg.dep_to_numpy(rt.dep)),
                svc=rt.query({"subsys": "svcstate"}))
        finally:
            rt.close()
    return out


def test_runtime_native_equals_python_leaves():
    r = _native_vs_python()
    for tree in ("state", "dep"):
        a, b = r["python"][tree], r["native"][tree]
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), (tree, k)


def test_runtime_native_equals_python_counters_and_reports():
    r = _native_vs_python()
    nat, py = dict(r["native"]["ctr"]), dict(r["python"]["ctr"])
    n = nat.pop("ref_native_decoded")
    assert n > 0 and "ref_fallback_decoded" not in nat
    assert py.pop("ref_fallback_decoded") == n
    assert nat == py
    assert r["native"]["reports"] == r["python"]["reports"]
    assert r["native"]["svc"] == r["python"]["svc"]
