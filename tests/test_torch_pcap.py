"""The port's pcap files and conversations against the reference's.

- ``write_pcap`` gives byte-equal files (microsecond and nanosecond
  stamps, each link type);
- ``parse_pcap`` of a capture of the six protocols (``chip_smoke.py``'s
  request-trace pcap at a small size: HTTP/1.1, Postgres, MongoDB,
  HTTP/2 with Huffman-coded HPACK and gRPC trailers, TDS, and TLS
  ClientHellos that carry no transaction) gives equal
  ``FlowConversation``s, with and without the pending flows, and the
  transactions written;
- ``transactions_to_records`` of each flow gives byte-equal record and
  name arrays;
- the REQ_TRACE frames of those records into both packages' runtimes on
  the CPU (the tiny geometry of ``test_torch_runtime.py``) give equal
  ``tracereq`` and ``svcstate`` JSON.
"""

import numpy as np
import pytest

import chip_smoke
from gyeeta_tpu.ingest import wire as j_wire
from gyeeta_tpu.runtime import Runtime as JRuntime
from gyeeta_tpu.trace import pcapfile as j_pcap
from gyeeta_tpu.trace import proto as j_proto
from gyeeta_tpu.utils.config import RuntimeOpts as JOpts
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.trace import pcapfile as t_pcap
from gyeeta_tpu_torch.trace import proto as t_proto
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from test_torch_runtime import OPTS, assert_json_equal, j_cfg, t_cfg
from test_torch_trace import same

N_SVCS = 12                 # the five protocols round-robin; 3 TLS conns


@pytest.fixture(scope="module")
def capture():
    frames, ends, cols = chip_smoke.trace_pcap(N_SVCS, seed=7)
    return frames, ends, cols, t_pcap.write_pcap(frames)


@pytest.mark.parametrize("nsec", [False, True])
@pytest.mark.parametrize("linktype", [1, 101, 113])
def test_write_pcap_byte_equal(capture, nsec, linktype):
    frames = capture[0][:400]
    assert t_pcap.write_pcap(frames, nsec=nsec, linktype=linktype) == \
        j_pcap.write_pcap(frames, nsec=nsec, linktype=linktype)


@pytest.mark.parametrize("pending", [False, True])
def test_parse_pcap_equal_conversations(capture, pending):
    frames, ends, cols, buf = capture
    t = t_pcap.parse_pcap(buf, include_pending=pending)
    j = j_pcap.parse_pcap(buf, include_pending=pending)
    assert same(j, t) and len(t) == N_SVCS
    # the transactions written, flow by flow
    idx = {e: i for i, e in enumerate(ends)}
    for f in t:
        i = idx[f.ser]
        m = cols["svc"] == i
        model = chip_smoke.TR_TXN_PROTOS[i % len(chip_smoke.TR_TXN_PROTOS)]
        assert [(x.api, x.is_error, x.bytes_in, x.bytes_out, x.resp_usec)
                for x in f.transactions] == [
            (model.APIS[a], bool(e), int(bi), int(bo), int(lat))
            for a, e, bi, bo, lat in zip(cols["api"][m], cols["err"][m],
                                         cols["bin"][m], cols["bout"][m],
                                         cols["lat"][m])]


def _trace_frames(proto, wire, flows, ends, host_of):
    idx = {e: i for i, e in enumerate(ends)}
    out = b""
    for f in flows:
        i = idx[f.ser]
        recs, names = proto.transactions_to_records(
            f.transactions, svc_glob_id=0x7000 + i, host_id=host_of(i))
        out += (wire.encode_frames_chunked(wire.NOTIFY_NAME_INTERN, names)
                + wire.encode_frames_chunked(wire.NOTIFY_REQ_TRACE, recs))
    return out


def test_transactions_to_records_of_the_capture(capture):
    frames, ends, cols, buf = capture
    flows = t_pcap.parse_pcap(buf)
    for f in flows:
        a = t_proto.transactions_to_records(f.transactions, 0x7001, 2)
        b = j_proto.transactions_to_records(f.transactions, 0x7001, 2)
        assert same(b, a)
    host_of = (lambda i: i % 3)
    assert _trace_frames(t_proto, t_wire, flows, ends, host_of) == \
        _trace_frames(j_proto, j_wire, flows, ends, host_of)


def test_pcap_traces_fold_equal_in_both_runtimes(capture):
    frames, ends, cols, buf = capture
    flows = t_pcap.parse_pcap(buf)
    stream = _trace_frames(t_proto, t_wire, flows, ends, lambda i: i % 3)
    now = [1.7e9]
    jr = JRuntime(j_cfg(), JOpts(**OPTS), clock=lambda: now[0])
    tr = TRuntime(t_cfg(), TOpts(**OPTS), clock=lambda: now[0],
                  device="cpu")
    try:
        out = {}
        for name, rt in (("j", jr), ("t", tr)):
            rt.feed(stream)
            rt.flush()
            rt.run_tick()
            out[name] = {s: rt.query({"subsys": s, "maxrecs": 1000})
                         for s in ("tracereq", "svcstate")}
        assert out["t"]["tracereq"]["nrecs"] == N_SVCS * 6
        assert_json_equal(out["j"], out["t"])
        assert int(np.sum([r["nreq"] for r in out["t"]["tracereq"]["recs"]])) \
            == len(cols["svc"])
    finally:
        jr.close()
        tr.close()
