"""GYT wire format: framing, record types and the control messages.

Counterpart of ``gyeeta_tpu/ingest/wire.py`` (a copy, since the port
imports nothing of the reference): COMM_HEADER-compatible framing
(``HEADER_DT`` — magic/total_sz/data_type/padding, 8-byte aligned, 16MB
cap), ``EVENT_NOTIFY`` (subtype + nevents), the two hot record types of
the flow path, ``TCP_CONN`` and ``RESP_SAMPLE``, and the record types of
``fold_all``'s sweep sections: ``LISTENER_STATE``, ``HOST_STATE``,
``AGGR_TASK_STATE``, ``TASK_PING``, ``CPU_MEM_STATE`` and ``REQ_TRACE``;
the runtime's ``NAME_INTERN`` (with the ``NAME_KIND_*`` namespaces),
``SWEEP_SEQ`` and ``AGENT_STATS``; edge pre-aggregation's
``SKETCH_DELTA`` (the ``DK_*`` kinds and their payload layouts) with
the ``PREAGG_DT`` advert; the inventory records the host-side
registries fold (``LISTENER_INFO``, ``HOST_INFO``, ``CGROUP_STATE``,
``MOUNT_STATE``, ``NETIF_STATE``); and the agent handshake, capture
control, throttle and query messages. Records are fixed width, so a
whole batch decodes with one ``np.frombuffer``.

Frames of any other subtype are skipped and their records counted
(``counts["unknown_records"]``), the reference's treatment of a subtype
it does not know.
"""

from __future__ import annotations

import struct as _struct
from typing import Optional

import numpy as np

MAGIC_PM = 0x47590001   # partha-equivalent agent -> aggregation tier
MAGIC_MS = 0x47590002   # aggregation tier -> global tier
MAGIC_NQ = 0x47590003   # query client (node webserver analogue)

MAX_COMM_DATA_SZ = 16 * 1024 * 1024   # 16MB frame cap

COMM_EVENT_NOTIFY = 1
COMM_QUERY_CMD = 2
COMM_QUERY_RESP = 3
COMM_REGISTER_REQ = 4     # agent handshake (ref PS_REGISTER_REQ_S :584)
COMM_REGISTER_RESP = 5
COMM_TRACE_SET = 6        # server→agent capture control (ref
#                           REQ_TRACE_SET, gy_comm_proto.h:3295; rides
#                           the event conn in reverse — the analogue of
#                           the reference's CLI_TYPE_RESP_REQ direction)
COMM_SUBSCRIBE_CMD = 8    # client→server streaming subscription: the
#                           payload is a standard QUERY_HDR + JSON
#                           envelope; the server answers an open-ended
#                           stream of QUERY_RESP frames (status
#                           QS_PARTIAL, seqid echoed) where EACH frame
#                           body is one complete subscription event
#                           (query/delta.py: full | delta | ack) —
#                           pushed when snaptick advances, not polled.
#                           The conn closing (either end) ends the
#                           subscription; a QS_ERROR frame reports a
#                           rejected registration. Pre-v6 servers
#                           answer unknown data_type like any other
#                           junk query frame (counted, conn survives).
COMM_THROTTLE = 7         # server→agent admission control: hold feeds
#                           in the agent spool for N ms (backpressure —
#                           server pressure becomes agent-side spooling
#                           instead of engine-side garbage; versioned
#                           like NOTIFY_AGENT_STATS — old agents skip
#                           unknown control dtypes)


NOTIFY_TCP_CONN = 10          # flow close/open records
NOTIFY_LISTENER_STATE = 11    # 5s per-service state
NOTIFY_HOST_STATE = 12        # 5s per-host rollup
NOTIFY_RESP_SAMPLE = 13       # raw response-time samples
NOTIFY_AGGR_TASK_STATE = 14   # 5s per-process-group state
NOTIFY_CPU_MEM_STATE = 15     # 2s host cpu/mem state
NOTIFY_NAME_INTERN = 16       # string-intern announcements
NOTIFY_REQ_TRACE = 17         # request-trace transactions (per-API)
NOTIFY_LISTENER_INFO = 18     # listener static metadata (ip/port/cmdline)
NOTIFY_HOST_INFO = 19         # static host inventory (hw/os/cloud)
NOTIFY_CGROUP_STATE = 20      # 5s per-cgroup stats
NOTIFY_MOUNT_STATE = 21       # mount/filesystem inventory + freespace
NOTIFY_NETIF_STATE = 22       # net interface inventory + traffic rates
NOTIFY_TASK_PING = 23         # process-group keepalive
NOTIFY_AGENT_STATS = 24       # agent self-report: spool drops/resends
NOTIFY_SWEEP_SEQ = 25         # agent sweep sequence mark (per-host
#                               high-water mark, checkpointed)
NOTIFY_SKETCH_DELTA = 26      # edge pre-aggregation deltas

MAX_CONNS_PER_BATCH = 2048
MAX_LISTENERS_PER_BATCH = 512
MAX_RESP_PER_BATCH = 4096
MAX_HOSTS_PER_BATCH = 4096
MAX_TASKS_PER_BATCH = 1200
MAX_PINGS_PER_BATCH = 2048
MAX_CPUMEM_PER_BATCH = 4096
MAX_TRACE_PER_BATCH = 4096

HEADER_DT = np.dtype([
    ("magic", "<u4"),
    ("total_sz", "<u4"),      # header + notify + payload, 8-aligned
    ("data_type", "<u4"),
    ("padding_sz", "<u4"),
])

EVENT_NOTIFY_DT = np.dtype([
    ("subtype", "<u4"),
    ("nevents", "<u4"),
])

IP_PORT_DT = np.dtype([
    ("ip", "u1", (16,)),      # IPv6 bytes; IPv4 mapped ::ffff:a.b.c.d
    ("port", "<u2"),
    ("pad", "u1", (6,)),
])

TCP_CONN_DT = np.dtype([
    ("cli", IP_PORT_DT),
    ("ser", IP_PORT_DT),
    ("nat_cli", IP_PORT_DT),
    ("nat_ser", IP_PORT_DT),
    ("tusec_start", "<u8"),
    ("tusec_close", "<u8"),
    ("cli_task_aggr_id", "<u8"),
    ("cli_related_listen_id", "<u8"),
    ("cli_madhava_id", "<u8"),
    ("peer_machine_id_hi", "<u8"),
    ("peer_machine_id_lo", "<u8"),
    ("ser_related_listen_id", "<u8"),
    ("ser_glob_id", "<u8"),
    ("ser_madhava_id", "<u8"),
    ("bytes_sent", "<u8"),     # client perspective
    ("bytes_rcvd", "<u8"),
    ("cli_pid", "<i4"),
    ("ser_pid", "<i4"),
    ("ser_conn_hash", "<u4"),
    ("ser_sock_inode", "<u4"),
    ("cli_comm_id", "<u8"),
    ("ser_comm_id", "<u8"),
    ("cli_cmdline_id", "<u8"),
    ("host_id", "<u4"),        # source agent index
    ("flags", "<u4"),          # bit0 connect, bit1 accept, bit2 loopback,
                               # bit3 pre-existing, bit4 notified-before
])

RESP_SAMPLE_DT = np.dtype([
    ("glob_id", "<u8"),
    ("resp_usec", "<u4"),
    ("host_id", "<u4"),
])

# LISTENER_STATE record (5s per-service gauges)
LISTENER_STATE_DT = np.dtype([
    ("glob_id", "<u8"),
    ("nqrys_5s", "<u4"),
    ("total_resp_5sec", "<u4"),
    ("nconns", "<u4"),
    ("nconns_active", "<u4"),
    ("ntasks", "<u4"),
    ("p95_5s_resp_ms", "<u4"),
    ("p95_5min_resp_ms", "<u4"),
    ("curr_kbytes_inbound", "<u4"),
    ("curr_kbytes_outbound", "<u4"),
    ("ser_errors", "<u4"),
    ("cli_errors", "<u4"),
    ("tasks_delay_usec", "<u4"),
    ("tasks_cpudelay_usec", "<u4"),
    ("tasks_blkiodelay_usec", "<u4"),
    ("tasks_user_cpu", "<u4"),
    ("tasks_sys_cpu", "<u4"),
    ("tasks_rss_mb", "<u4"),
    ("ntasks_issue", "<u2"),
    ("is_http_svc", "u1"),
    ("curr_state", "u1"),
    ("curr_issue", "u1"),
    ("issue_bit_hist", "u1"),
    ("high_resp_bit_hist", "u1"),
    ("last_issue_subsrc", "u1"),
    ("query_flags", "<u4"),
    ("host_id", "<u4"),
    ("pad", "u1", (4,)),
    ("issue_string_id", "<u8"),  # interned issue string
])

# HOST_STATE record (5s per-host rollup with the agent's own verdicts)
HOST_STATE_DT = np.dtype([
    ("curr_time_usec", "<u8"),
    ("ntasks_issue", "<u4"),
    ("ntasks_severe", "<u4"),
    ("ntasks", "<u4"),
    ("nlisten_issue", "<u4"),
    ("nlisten_severe", "<u4"),
    ("nlisten", "<u4"),
    ("curr_state", "u1"),
    ("issue_bit_hist", "u1"),
    ("cpu_issue", "u1"),
    ("mem_issue", "u1"),
    ("severe_cpu_issue", "u1"),
    ("severe_mem_issue", "u1"),
    ("pad", "u1", (2,)),
    ("host_id", "<u4"),
    ("pad2", "u1", (4,)),
])

# AGGR_TASK_STATE record (5s process-group state; comm string interned)
AGGR_TASK_DT = np.dtype([
    ("aggr_task_id", "<u8"),
    ("comm_id", "<u8"),
    ("related_listen_id", "<u8"),
    ("tcp_kbytes", "<u4"),
    ("tcp_conns", "<u4"),
    ("total_cpu_pct", "<f4"),
    ("rss_mb", "<u4"),
    ("cpu_delay_msec", "<u4"),
    ("vm_delay_msec", "<u4"),
    ("blkio_delay_msec", "<u4"),
    ("forks_sec", "<f4"),
    ("ntasks_total", "<u2"),
    ("ntasks_issue", "<u2"),
    ("curr_state", "u1"),
    ("curr_issue", "u1"),
    ("pad", "u1", (2,)),
    ("host_id", "<u4"),
    ("pad2", "u1", (4,)),
])

# TASK_PING record: a process-group keepalive (the fold refreshes the
# group's last-seen tick and never inserts)
TASK_PING_DT = np.dtype([
    ("aggr_task_id", "<u8"),
    ("host_id", "<u4"),
    ("pad", "u1", (4,)),
])

# CPU_MEM_STATE record: raw 2s host gauges, classified server-side
CPU_MEM_DT = np.dtype([
    ("cpu_pct", "<f4"),
    ("usercpu_pct", "<f4"),
    ("syscpu_pct", "<f4"),
    ("iowait_pct", "<f4"),
    ("max_core_cpu_pct", "<f4"),
    ("cs_sec", "<f4"),
    ("forks_sec", "<f4"),
    ("procs_running", "<f4"),
    ("rss_pct", "<f4"),
    ("commit_pct", "<f4"),
    ("swap_free_pct", "<f4"),
    ("pg_inout_sec", "<f4"),
    ("swap_inout_sec", "<f4"),
    ("allocstall_sec", "<f4"),
    ("oom_kills", "<f4"),
    ("ncpus", "<f4"),
    ("host_id", "<u4"),
    ("pad", "u1", (4,)),
])

# REQ_TRACE record: one parsed request/response transaction
REQ_TRACE_DT = np.dtype([
    ("svc_glob_id", "<u8"),
    ("api_id", "<u8"),            # interned normalized signature
    ("conn_id", "<u8"),           # traced connection identity
    ("cli_task_aggr_id", "<u8"),  # requesting process group
    ("cli_comm_id", "<u8"),       # interned client comm
    ("tusec", "<u8"),             # request first-byte time
    ("resp_usec", "<u4"),
    ("bytes_in", "<u4"),
    ("bytes_out", "<u4"),
    ("status", "<u2"),            # HTTP status / PG 0-ok 1-err
    ("proto", "u1"),
    ("is_error", "u1"),
    ("host_id", "<u4"),
    ("pad", "u1", (4,)),
])

# AGENT_STATS record: agent-side delivery-continuity counters (deltas)
AGENT_STATS_DT = np.dtype([
    ("host_id", "<u4"),
    ("spool_dropped", "<u4"),
    ("spool_dropped_records", "<u4"),
    ("spool_resent", "<u4"),
    ("connect_timeouts", "<u4"),
    ("pad", "<u4"),
])

MAX_AGENT_STATS_PER_BATCH = 64

# SWEEP_SEQ record: the per-sweep sequence mark of one agent
SWEEP_SEQ_DT = np.dtype([
    ("host_id", "<u4"),
    ("pad", "<u4"),
    ("seq", "<u8"),                    # monotone per agent process
])

MAX_SWEEP_SEQ_PER_BATCH = 64

# LISTENER_INFO record: static listener metadata
LISTENER_INFO_DT = np.dtype([
    ("glob_id", "<u8"),
    ("addr", IP_PORT_DT),
    ("tusec_start", "<u8"),
    ("cmdline_id", "<u8"),        # interned command line
    ("comm_id", "<u8"),           # interned process comm
    ("related_listen_id", "<u8"),
    ("pid", "<i4"),
    ("is_any_ip", "u1"),
    ("is_http", "u1"),
    ("pad", "u1", (2,)),
    ("host_id", "<u4"),
    ("pad2", "u1", (4,)),
])

MAX_LISTENER_INFO_PER_BATCH = 1024

# HOST_INFO record: static host inventory (strings interned)
HOST_INFO_DT = np.dtype([
    ("host_id", "<u4"),
    ("ncpus", "<u2"),
    ("nnuma", "<u2"),
    ("ram_mb", "<u4"),
    ("swap_mb", "<u4"),
    ("boot_tusec", "<u8"),
    ("kern_ver_id", "<u8"),
    ("distro_id", "<u8"),
    ("cputype_id", "<u8"),
    ("instance_id", "<u8"),
    ("region_id", "<u8"),
    ("zone_id", "<u8"),
    ("virt_type", "u1"),
    ("cloud_type", "u1"),
    ("is_k8s", "u1"),
    ("pad", "u1", (5,)),
])

MAX_HOST_INFO_PER_BATCH = 1024

# CGROUP_STATE record: 5s per-cgroup sweep
CGROUP_DT = np.dtype([
    ("cg_id", "<u8"),
    ("dir_id", "<u8"),
    ("cpu_pct", "<f4"),
    ("cpu_limit_pct", "<f4"),
    ("cpu_throttled_pct", "<f4"),
    ("rss_mb", "<f4"),
    ("memory_limit_mb", "<f4"),
    ("pgmajfault_sec", "<f4"),
    ("nprocs", "<u4"),
    ("is_v2", "u1"),
    ("state", "u1"),
    ("pad", "u1", (2,)),
    ("host_id", "<u4"),
    ("pad2", "u1", (4,)),
])

MAX_CGROUPS_PER_BATCH = 2048

# MOUNT_STATE record: mount/filesystem inventory with freespace
MOUNT_DT = np.dtype([
    ("mnt_id", "<u8"),
    ("dir_id", "<u8"),
    ("fstype_id", "<u8"),
    ("size_mb", "<f4"),
    ("free_mb", "<f4"),
    ("used_pct", "<f4"),
    ("inodes_used_pct", "<f4"),
    ("is_network_fs", "u1"),
    ("pad", "u1", (3,)),
    ("host_id", "<u4"),
])

MAX_MOUNTS_PER_BATCH = 1024

# NETIF_STATE record: interface inventory + rate deltas
NETIF_DT = np.dtype([
    ("if_id", "<u8"),
    ("name_id", "<u8"),
    ("speed_mbps", "<f4"),
    ("rx_mb_sec", "<f4"),
    ("tx_mb_sec", "<f4"),
    ("rx_errs_sec", "<f4"),
    ("tx_errs_sec", "<f4"),
    ("is_up", "u1"),
    ("pad", "u1", (3,)),
    ("host_id", "<u4"),
    ("pad2", "u1", (4,)),
])

MAX_NETIF_PER_BATCH = 1024

# NAME_INTERN record: strings travel once as (id, kind, utf-8 bytes) and
# thereafter as 64-bit ids inside hot records; queries resolve them back
# through utils/intern.InternTable
NAME_KIND_COMM = 1      # process comm / command name
NAME_KIND_SVC = 2       # service (listener) name, id == glob_id
NAME_KIND_HOST = 3      # hostname, id == host_id
NAME_KIND_API = 4       # normalized API signature, id == hash(signature)
NAME_KIND_MISC = 5      # host-info / cgroup-path / other metadata strings
MAX_NAME_BYTES = 48

NAME_INTERN_DT = np.dtype([
    ("name_id", "<u8"),
    ("kind", "<u4"),
    ("nlen", "<u4"),
    ("name", "u1", (MAX_NAME_BYTES,)),
])

MAX_NAMES_PER_BATCH = 1024

# SKETCH_DELTA record: one mergeable partial of an edge-folding agent
# (``kind`` selects how the 96-byte payload decodes)
DELTA_PAYLOAD_BYTES = 96

DELTA_DT = np.dtype([
    ("key_hi", "<u4"),
    ("key_lo", "<u4"),
    ("aux_hi", "<u4"),
    ("aux_lo", "<u4"),
    ("payload", "u1", (DELTA_PAYLOAD_BYTES,)),
    ("errb", "<f4"),
    ("kind", "u1"),
    ("flags", "u1"),
    ("nitem", "<u2"),
    ("host_id", "<u4"),
    ("pad", "u1", (4,)),
])

# payload interpretations (all little-endian, packed)
DELTA_PAIR_DT = np.dtype([("idx", "<u2"), ("wt", "<f4")])   # 6 B/item
DELTA_FLOW_DT = np.dtype([("hi", "<u4"), ("lo", "<u4"),
                          ("val", "<f4")])                  # 12 B/item
DELTA_PAIRS = DELTA_PAYLOAD_BYTES // DELTA_PAIR_DT.itemsize    # 16
DELTA_FLOWS = DELTA_PAYLOAD_BYTES // DELTA_FLOW_DT.itemsize    # 8
DELTA_SAMPLES = DELTA_PAYLOAD_BYTES // 4                       # 24 f32

# DK_* record kinds (unknown kinds are skipped and counted at decode)
DK_SVC_CTR = 1    # payload f32[6]: bytes_sent, bytes_rcvd, n_close,
#                   dur_sum_us, n_conn_records, n_resp_records
DK_SVC_HIST = 2   # pairs (resp loghist bucket, count)
DK_SVC_HLL = 3    # pairs (register, rank) of the per-svc client HLL
DK_GLOB_HLL = 4   # pairs (register, rank) of the global flow HLL
DK_SVC_TD = 5     # f32 samples for the per-svc t-digest stage
DK_FLOW = 6       # packed (flow_hi, flow_lo, bytes) aggregates
DK_DEP = 7        # one dependency edge: key = server svc, aux = client
#                   entity, payload f32[2] = [nconn, bytes]
DK_RESID = 8      # errb = flow bytes truncated by the agent's flow_max

MAX_DELTA_PER_BATCH = 1024

DTYPE_OF_SUBTYPE = {
    NOTIFY_SKETCH_DELTA: DELTA_DT,
    NOTIFY_TCP_CONN: TCP_CONN_DT,
    NOTIFY_LISTENER_STATE: LISTENER_STATE_DT,
    NOTIFY_HOST_STATE: HOST_STATE_DT,
    NOTIFY_RESP_SAMPLE: RESP_SAMPLE_DT,
    NOTIFY_AGGR_TASK_STATE: AGGR_TASK_DT,
    NOTIFY_CPU_MEM_STATE: CPU_MEM_DT,
    NOTIFY_NAME_INTERN: NAME_INTERN_DT,
    NOTIFY_REQ_TRACE: REQ_TRACE_DT,
    NOTIFY_LISTENER_INFO: LISTENER_INFO_DT,
    NOTIFY_HOST_INFO: HOST_INFO_DT,
    NOTIFY_CGROUP_STATE: CGROUP_DT,
    NOTIFY_MOUNT_STATE: MOUNT_DT,
    NOTIFY_NETIF_STATE: NETIF_DT,
    NOTIFY_TASK_PING: TASK_PING_DT,
    NOTIFY_AGENT_STATS: AGENT_STATS_DT,
    NOTIFY_SWEEP_SEQ: SWEEP_SEQ_DT,
}

# per-type batch caps enforced at decode
MAX_OF_SUBTYPE = {
    NOTIFY_TCP_CONN: MAX_CONNS_PER_BATCH,
    NOTIFY_LISTENER_STATE: MAX_LISTENERS_PER_BATCH,
    NOTIFY_HOST_STATE: MAX_HOSTS_PER_BATCH,
    NOTIFY_RESP_SAMPLE: MAX_RESP_PER_BATCH,
    NOTIFY_AGGR_TASK_STATE: MAX_TASKS_PER_BATCH,
    NOTIFY_CPU_MEM_STATE: MAX_CPUMEM_PER_BATCH,
    NOTIFY_NAME_INTERN: MAX_NAMES_PER_BATCH,
    NOTIFY_REQ_TRACE: MAX_TRACE_PER_BATCH,
    NOTIFY_LISTENER_INFO: MAX_LISTENER_INFO_PER_BATCH,
    NOTIFY_HOST_INFO: MAX_HOST_INFO_PER_BATCH,
    NOTIFY_CGROUP_STATE: MAX_CGROUPS_PER_BATCH,
    NOTIFY_MOUNT_STATE: MAX_MOUNTS_PER_BATCH,
    NOTIFY_NETIF_STATE: MAX_NETIF_PER_BATCH,
    NOTIFY_TASK_PING: MAX_PINGS_PER_BATCH,
    NOTIFY_AGENT_STATS: MAX_AGENT_STATS_PER_BATCH,
    NOTIFY_SWEEP_SEQ: MAX_SWEEP_SEQ_PER_BATCH,
    NOTIFY_SKETCH_DELTA: MAX_DELTA_PER_BATCH,
}

for _name, _dt in [("HEADER_DT", HEADER_DT),
                   ("EVENT_NOTIFY_DT", EVENT_NOTIFY_DT)] + [
        (f"subtype {k}", v) for k, v in DTYPE_OF_SUBTYPE.items()]:
    if _dt.itemsize % 8:
        raise AssertionError((_name, _dt.itemsize))

# Checksum: a frame whose padding_sz carries CHK_FLAG holds, in bits
# 8..15, the XOR fold of every byte after the 16B header. It detects
# every single-byte corruption; flagless frames skip verification.
CHK_FLAG = 0x80000000
_CHK_SHIFT = 8


def _xor8(b) -> int:
    a = np.frombuffer(b, np.uint8)
    return int(np.bitwise_xor.reduce(a)) if a.size else 0


class FrameError(ValueError):
    """Corrupt / hostile framing. ``reason`` is a short machine label
    (``bad_magic`` / ``bad_size`` / ``checksum`` / ``bad_dtype`` /
    ``bad_frame``)."""

    def __init__(self, msg: str, reason: str = "bad_frame"):
        super().__init__(msg)
        self.reason = reason


def encode_frame(subtype: int, records: np.ndarray,
                 magic: int = MAGIC_PM) -> bytes:
    """Frame a structured record array as COMM_HEADER+EVENT_NOTIFY+payload.

    Raises FrameError for frames the decoder would reject (per-subtype
    batch caps, 16MB frame cap)."""
    cap = MAX_OF_SUBTYPE.get(subtype)
    if cap is not None and len(records) > cap:
        raise FrameError(
            f"{len(records)} records > cap {cap} for subtype {subtype}")
    payload = records.tobytes()
    total = HEADER_DT.itemsize + EVENT_NOTIFY_DT.itemsize + len(payload)
    if total >= MAX_COMM_DATA_SZ:
        raise FrameError(f"frame {total} bytes exceeds 16MB cap")
    hdr = np.zeros((), HEADER_DT)
    hdr["magic"] = magic
    hdr["total_sz"] = total          # records are 8-aligned → no padding
    hdr["data_type"] = COMM_EVENT_NOTIFY
    ev = np.zeros((), EVENT_NOTIFY_DT)
    ev["subtype"] = subtype
    ev["nevents"] = len(records)
    ev_b = ev.tobytes()
    hdr["padding_sz"] = CHK_FLAG | (
        (_xor8(ev_b) ^ _xor8(payload)) << _CHK_SHIFT)
    return hdr.tobytes() + ev_b + payload


def encode_frames_chunked(subtype: int, records: np.ndarray,
                          magic: int = MAGIC_PM) -> bytes:
    """Frame a record array of any length, split at the subtype's cap."""
    cap = MAX_OF_SUBTYPE.get(subtype, len(records) or 1)
    return b"".join(encode_frame(subtype, records[i:i + cap], magic)
                    for i in range(0, len(records), cap))


def decode_frames(buf: bytes, counts: Optional[dict] = None,
                  event_only: bool = False):
    """Parse a byte stream of frames → (list of (subtype, records),
    bytes_consumed). A trailing partial frame is left for the caller.

    Hardening, as in the reference: known subtypes enforce EXACT sizing
    (``nevents·itemsize`` must fill the frame) and their batch caps;
    frames flagged with :data:`CHK_FLAG` verify the XOR checksum; records
    of skipped unknown-subtype frames accumulate under
    ``counts["unknown_records"]``; with ``event_only`` a non-EVENT
    ``data_type`` raises instead of being skipped.
    """
    frames = []
    off = 0
    n = len(buf)
    hsz = HEADER_DT.itemsize
    esz = EVENT_NOTIFY_DT.itemsize
    while off + hsz <= n:
        hdr = np.frombuffer(buf, HEADER_DT, count=1, offset=off)[0]
        if hdr["magic"] not in (MAGIC_PM, MAGIC_MS, MAGIC_NQ):
            raise FrameError(f"bad magic {hdr['magic']:#x} at {off}",
                             reason="bad_magic")
        total = int(hdr["total_sz"])
        if total < hsz + esz or total >= MAX_COMM_DATA_SZ:
            raise FrameError(f"bad total_sz {total} at {off}",
                             reason="bad_size")
        if off + total > n:
            break  # partial frame
        padf = int(hdr["padding_sz"])
        if padf & CHK_FLAG and \
                _xor8(buf[off + hsz: off + total]) \
                != (padf >> _CHK_SHIFT) & 0xFF:
            raise FrameError(f"payload checksum mismatch at {off}",
                             reason="checksum")
        if hdr["data_type"] == COMM_EVENT_NOTIFY:
            ev = np.frombuffer(buf, EVENT_NOTIFY_DT, 1, off + hsz)[0]
            subtype = int(ev["subtype"])
            nev = int(ev["nevents"])
            dt = DTYPE_OF_SUBTYPE.get(subtype)
            if dt is not None:
                if nev > MAX_OF_SUBTYPE[subtype]:
                    raise FrameError(
                        f"nevents {nev} > cap {MAX_OF_SUBTYPE[subtype]} "
                        f"for subtype {subtype} at {off}",
                        reason="bad_size")
                need = hsz + esz + nev * dt.itemsize
                if need != total:
                    raise FrameError(
                        f"nevents {nev} does not fill frame at {off} "
                        f"(need {need}, total {total})",
                        reason="bad_size")
                recs = np.frombuffer(buf, dt, nev, off + hsz + esz)
                frames.append((subtype, recs))
            elif counts is not None:
                counts["unknown_records"] = \
                    counts.get("unknown_records", 0) + nev
        elif event_only:
            raise FrameError(
                f"unexpected data_type {int(hdr['data_type'])} on the "
                f"event stream at {off}", reason="bad_dtype")
        off += total
    return frames, off


def drain2(buf: bytes) -> tuple[dict, int, int]:
    """Byte stream → ({subtype: record array}, consumed, unknown_recs):
    the reference's drain (``ingest/native`` ``drain2``) on its Python
    path, which it documents as identical in semantics to the native
    one. Every known frame's records are concatenated per subtype, in
    frame order, with no empty entries; ``unknown_recs`` counts the records of skipped
    unknown-subtype frames; a trailing partial frame is not consumed."""
    cnt: dict = {}
    frames, consumed = decode_frames(buf, counts=cnt, event_only=True)
    parts: dict = {}
    for subtype, recs in frames:
        if len(recs):
            parts.setdefault(subtype, []).append(recs)
    # one byte-level concatenation per subtype: the reference appends
    # frame by frame, which copies the structured records O(frames²)
    out = {sub: np.concatenate([r.view(np.uint8) for r in rs]).view(
        rs[0].dtype) for sub, rs in parts.items()}
    return out, consumed, cnt.get("unknown_records", 0)



_HDR_PREFIX_UNPACK = _struct.Struct("<II").unpack_from


def complete_prefix(buf: bytes) -> int:
    """Length of the longest prefix of COMPLETE frames: a header walk,
    no payload touched (the capture replay's reassembly before a
    host-id remap). Raises FrameError on a corrupt header."""
    off = 0
    n = len(buf)
    hsz = HEADER_DT.itemsize
    esz = EVENT_NOTIFY_DT.itemsize
    magics = (MAGIC_PM, MAGIC_MS, MAGIC_NQ)
    while off + hsz <= n:
        magic, total = _HDR_PREFIX_UNPACK(buf, off)
        if magic not in magics:
            raise FrameError(f"bad magic {magic:#x} at {off}",
                             reason="bad_magic")
        # the bound decode_frames holds a header to
        if total < hsz + esz or total >= MAX_COMM_DATA_SZ:
            raise FrameError(f"bad total_sz {total} at {off}",
                             reason="bad_size")
        if off + total > n:
            break
        off += total
    return off

# --------------------------------------------------- pre-aggregation advert
# The REGISTER_RESP v5 tail: the server's sketch geometry, which an
# edge-folding agent folds with so that its partials land in exactly the
# buckets and registers the raw fold would hit.
PREAGG_MAGIC = 0x50524147        # "GARP" little-endian sanity word

PREAGG_DT = np.dtype([
    ("magic", "<u4"),
    ("hll_p_svc", "<u4"),        # per-svc distinct-client HLL precision
    ("hll_p_global", "<u4"),     # global flow HLL precision
    ("td_stride", "<u4"),        # digest duty cycle (1-in-N samples)
    ("resp_nbuckets", "<u4"),    # resp loghist spec (vmin/vmax below)
    ("flow_max", "<u4"),         # per-sweep flow-aggregate cap
    ("resp_vmin", "<f8"),
    ("resp_vmax", "<f8"),
])

_PREAGG_FIELDS = ("hll_p_svc", "hll_p_global", "td_stride",
                  "resp_nbuckets", "flow_max", "resp_vmin", "resp_vmax")


def encode_preagg(params: dict) -> bytes:
    """Pre-aggregation advert dict → the REGISTER_RESP v5 tail."""
    r = np.zeros((), PREAGG_DT)
    r["magic"] = PREAGG_MAGIC
    for f in _PREAGG_FIELDS:
        r[f] = params[f]
    return r.tobytes()


def decode_preagg(buf: bytes):
    """v5 tail bytes → params dict, or None when absent or foreign."""
    if len(buf) < PREAGG_DT.itemsize:
        return None
    r = np.frombuffer(buf, PREAGG_DT, count=1)[0]
    if int(r["magic"]) != PREAGG_MAGIC:
        return None
    return {f: (float(r[f]) if f.startswith("resp_v") else int(r[f]))
            for f in _PREAGG_FIELDS}

# ----------------------------------------------------- control-plane msgs
# Registration (ref PS_REGISTER_REQ_S/PM_CONNECT_CMD_S,
# gy_comm_proto.h:584-952, version gates :55-56): one message class —
# single-controller design collapses the partha→shyama→madhava two-step
# into one handshake; machine-id → host_id stickiness replaces
# assign_partha_madhava placement (gy_shconnhdlr.cc:5876).
REGISTER_REQ_DT = np.dtype([
    ("machine_id_hi", "<u8"),    # SYS_HARDWARE machine-id analogue
    ("machine_id_lo", "<u8"),
    ("wire_version", "<u4"),
    ("conn_type", "<u4"),        # CONN_EVENT | CONN_QUERY
    ("hostname_id", "<u8"),      # interned hostname (announce separately)
])

REGISTER_RESP_DT = np.dtype([
    ("status", "<u4"),
    ("host_id", "<u4"),          # assigned dense engine index
    ("curr_version", "<u4"),
    ("pad", "u1", (4,)),
])

CONN_EVENT = 1
CONN_QUERY = 2

REG_OK = 0
REG_ERR_VERSION = 1              # older than MIN_WIRE_VERSION
REG_ERR_CAPACITY = 2             # host slots exhausted (n_hosts)

# Trace capture control (server→agent): which services to capture.
# One record per service; enable=0 stops capture (ref REQ_TRACE_SET /
# SM_REQ_TRACE_DEF_NEW→partha distribution, gy_comm_proto.h:3295,3377).
TRACE_SET_DT = np.dtype([
    ("svc_glob_id", "<u8"),
    ("enable", "u1"),
    ("pad", "u1", (7,)),
])

MAX_TRACE_SET_PER_BATCH = 4096


def encode_trace_set(svc_ids, enable) -> bytes:
    """(svc_glob_ids, enable flags) → COMM_TRACE_SET frame(s); large
    sets chunk at the batch cap like every other record stream."""
    recs = np.zeros(len(svc_ids), TRACE_SET_DT)
    recs["svc_glob_id"] = np.asarray(svc_ids, np.uint64)
    recs["enable"] = np.asarray(enable, np.uint8)
    return b"".join(
        _frame(COMM_TRACE_SET,
               recs[i: i + MAX_TRACE_SET_PER_BATCH].tobytes(), MAGIC_MS)
        for i in range(0, max(len(recs), 1), MAX_TRACE_SET_PER_BATCH))


def decode_trace_set(payload: bytes) -> np.ndarray:
    n = len(payload) // TRACE_SET_DT.itemsize
    return np.frombuffer(payload, TRACE_SET_DT, count=n)


# Admission control (server→agent backpressure): which feed classes to
# hold in the agent's spool, for how long. Priority-aware shedding
# (PSketch, PAPERS.md): trace/pcap feeds throttle BEFORE svc/task
# state, so health classification degrades last. hold_ms=0 releases a
# class early. Unknown feed ids are ignored by receivers (forward
# compatible, the NOTIFY_AGENT_STATS versioning discipline).
FEED_TRACE = 1            # request-trace / pcap transaction streams
FEED_ALL = 2              # every sweep (state feeds included)

THROTTLE_DT = np.dtype([
    ("feed", "<u4"),
    ("hold_ms", "<u4"),
])

assert THROTTLE_DT.itemsize % 8 == 0


def encode_throttle(feeds, hold_ms: int, magic: int = MAGIC_MS) -> bytes:
    """(feed classes, hold duration ms) → one COMM_THROTTLE frame."""
    return encode_throttle_multi([(f, hold_ms) for f in feeds], magic)


def encode_throttle_multi(pairs, magic: int = MAGIC_MS) -> bytes:
    """[(feed, hold_ms), …] → one COMM_THROTTLE frame (hold 0 releases
    that class early)."""
    pairs = list(pairs)
    recs = np.zeros(len(pairs), THROTTLE_DT)
    recs["feed"] = np.asarray([p[0] for p in pairs], np.uint32)
    recs["hold_ms"] = np.asarray([p[1] for p in pairs], np.uint32)
    return _frame(COMM_THROTTLE, recs.tobytes(), magic)


def decode_throttle(payload: bytes) -> np.ndarray:
    n = len(payload) // THROTTLE_DT.itemsize
    return np.frombuffer(payload, THROTTLE_DT, count=n)


# Query multiplexing (ref QUERY_CMD/QUERY_RESPONSE, gy_comm_proto.h:502,
# 536; ≤4K outstanding :53): seqid echoes back with the JSON response.
QUERY_HDR_DT = np.dtype([
    ("seqid", "<u8"),
    ("status", "<u4"),           # req: 0; resp: QS_*
    ("nbytes", "<u4"),           # JSON payload bytes (before pad)
])

QS_OK = 0
QS_ERROR = 1                     # payload = {"error": msg}
QS_BUSY = 2                      # too many outstanding queries
QS_PARTIAL = 3                   # streamed chunk; more frames follow

MAX_OUTSTANDING_QUERIES = 64     # per conn (global 4K analogue)

# streamed-response chunk size: large results ride as a sequence of
# QS_PARTIAL frames closed by the final status frame — the reference
# streams web responses in 16MB heap-buffer chunks up to 4GB total
# (gy_msg_comm.h buffer discipline); 1MB chunks keep frames well under
# the 16MB frame cap with room for framing
QUERY_CHUNK_BYTES = 1 << 20


def _frame(data_type: int, payload: bytes, magic: int) -> bytes:
    pad = (-len(payload)) % 8
    total = HEADER_DT.itemsize + len(payload) + pad
    if total >= MAX_COMM_DATA_SZ:
        raise FrameError(f"frame {total} bytes exceeds 16MB cap")
    hdr = np.zeros((), HEADER_DT)
    hdr["magic"] = magic
    hdr["total_sz"] = total
    hdr["data_type"] = data_type
    hdr["padding_sz"] = pad
    return hdr.tobytes() + payload + b"\x00" * pad


def encode_register_req(machine_id: int, conn_type: int,
                        wire_version: int, hostname_id: int = 0) -> bytes:
    r = np.zeros((), REGISTER_REQ_DT)
    r["machine_id_hi"] = np.uint64((machine_id >> 64)
                                   & 0xFFFFFFFFFFFFFFFF)
    r["machine_id_lo"] = np.uint64(machine_id & 0xFFFFFFFFFFFFFFFF)
    r["wire_version"] = wire_version
    r["conn_type"] = conn_type
    r["hostname_id"] = np.uint64(hostname_id)
    return _frame(COMM_REGISTER_REQ, r.tobytes(), MAGIC_PM)


def encode_register_resp(status: int, host_id: int,
                         curr_version: int, last_seq: int = 0,
                         preagg: dict | None = None) -> bytes:
    """REGISTER_RESP + the v4 trailing extension: the server's durable
    per-host sweep-seq high-water mark (``last_seq``), + the optional
    v5 pre-aggregation advert (``preagg``, see PREAGG_DT). Agents built
    before v4 parse the fixed prefix and ignore the tail; agents that
    understand it prune already-durable sweeps from their resend spool
    (the WAL dedup contract, see NOTIFY_SWEEP_SEQ)."""
    r = np.zeros((), REGISTER_RESP_DT)
    r["status"] = status
    r["host_id"] = host_id
    r["curr_version"] = curr_version
    ext = np.uint64(last_seq).tobytes()
    if preagg is not None:
        ext += encode_preagg(preagg)
    return _frame(COMM_REGISTER_RESP, r.tobytes() + ext, MAGIC_MS)


def decode_register_resp(payload: bytes) -> tuple:
    """REGISTER_RESP payload → (status, host_id, curr_version,
    last_seq, preagg). ``last_seq`` is 0 when the server predates the
    v4 extension (16-byte fixed payload only); ``preagg`` is None
    unless the server advertised the v5 edge pre-aggregation tail."""
    r = np.frombuffer(payload, REGISTER_RESP_DT, count=1)[0]
    last_seq = 0
    preagg = None
    base = REGISTER_RESP_DT.itemsize
    if len(payload) >= base + 8:
        last_seq = int(np.frombuffer(payload, "<u8", 1, base)[0])
        preagg = decode_preagg(payload[base + 8:])
    return (int(r["status"]), int(r["host_id"]),
            int(r["curr_version"]), last_seq, preagg)


def encode_query(seqid: int, obj, status: int = QS_OK,
                 resp: bool = False) -> bytes:
    import json as _json
    payload = _json.dumps(obj).encode()
    h = np.zeros((), QUERY_HDR_DT)
    h["seqid"] = np.uint64(seqid)
    h["status"] = status
    h["nbytes"] = len(payload)
    return _frame(COMM_QUERY_RESP if resp else COMM_QUERY_CMD,
                  h.tobytes() + payload, MAGIC_NQ)


def iter_query_frames(seqid: int, obj, status: int = QS_OK,
                      chunk_bytes: int = QUERY_CHUNK_BYTES):
    """Yield a streamed frame sequence for a (possibly large) JSON
    response: N-1 QS_PARTIAL chunks + one final frame carrying
    ``status``. A small response is exactly one ordinary frame.
    Writers send each frame as it yields (bounded transport memory; the
    JSON text itself is materialized once — ``json.dumps`` — so peak is
    ~1× payload, vs ~3× when the whole frame blob is pre-joined)."""
    import json as _json
    payload = _json.dumps(obj).encode()
    for off in range(0, max(len(payload), 1), chunk_bytes):
        body = payload[off: off + chunk_bytes]
        last = off + chunk_bytes >= len(payload)
        h = np.zeros((), QUERY_HDR_DT)
        h["seqid"] = np.uint64(seqid)
        h["status"] = status if last else QS_PARTIAL
        h["nbytes"] = len(body)
        yield _frame(COMM_QUERY_RESP, h.tobytes() + body, MAGIC_NQ)


def encode_query_frames(seqid: int, obj, status: int = QS_OK,
                        chunk_bytes: int = QUERY_CHUNK_BYTES) -> bytes:
    """Joined form of :func:`iter_query_frames` (tests / small results)."""
    return b"".join(iter_query_frames(seqid, obj, status, chunk_bytes))


def decode_query_chunk(payload: bytes):
    """QUERY_RESP frame payload → (seqid, status, raw_body_bytes).

    Callers accumulate QS_PARTIAL bodies and JSON-parse once the final
    status arrives (the streamed-response read side)."""
    h = np.frombuffer(payload, QUERY_HDR_DT, count=1)[0]
    n = int(h["nbytes"])
    body = payload[QUERY_HDR_DT.itemsize: QUERY_HDR_DT.itemsize + n]
    return int(h["seqid"]), int(h["status"]), body


def decode_query_payload(payload: bytes):
    """QUERY_CMD/RESP frame payload → (seqid, status, json_obj)."""
    import json as _json
    h = np.frombuffer(payload, QUERY_HDR_DT, count=1)[0]
    n = int(h["nbytes"])
    body = payload[QUERY_HDR_DT.itemsize: QUERY_HDR_DT.itemsize + n]
    return int(h["seqid"]), int(h["status"]), _json.loads(body or b"null")


def count_events(buf: bytes) -> int:
    """Total EVENT_NOTIFY records across the complete frames of ``buf``
    (header walk only — payloads untouched). The spool/loss-accounting
    helper: agents count what a sweep carries before spooling it, so a
    dropped sweep's records can be attributed, not silently lost."""
    n = 0
    off = 0
    ln = len(buf)
    hsz = HEADER_DT.itemsize
    esz = EVENT_NOTIFY_DT.itemsize
    while off + hsz <= ln:
        _magic, total = _HDR_PREFIX_UNPACK(buf, off)
        if total < hsz or off + total > ln:
            break
        dtype = int.from_bytes(buf[off + 8: off + 12], "little")
        if dtype == COMM_EVENT_NOTIFY and total >= hsz + esz:
            n += int.from_bytes(buf[off + hsz + 4: off + hsz + 8],
                                "little")
        off += total
    return n


async def read_frame(reader, first: bytes = b"",
                     timeout=None) -> tuple[int, bytes]:
    """THE validated async frame reader → ``(data_type, payload)``.

    Shared by the agent and the server (one validation discipline on
    both ends of the wire): magic gate, ``total_sz`` bounds (a corrupt
    header can neither hang ``readexactly`` on a multi-MB read nor
    crash it on a short one) and ``padding_sz`` bounds, all checked
    BEFORE the body read. ``first`` carries bytes already peeked off
    the stream. Raises :class:`FrameError` (with a ``reason``) on a
    poison or truncated header, ``asyncio.IncompleteReadError`` on a
    clean EOF at a frame boundary, and ``asyncio.TimeoutError`` when
    ``timeout`` (whole-frame deadline, seconds) expires."""
    if timeout is not None:
        import asyncio
        return await asyncio.wait_for(_read_frame(reader, first), timeout)
    return await _read_frame(reader, first)


async def _read_frame(reader, first: bytes = b"") -> tuple[int, bytes]:
    import asyncio
    hsz = HEADER_DT.itemsize
    try:
        hdr_b = first + await reader.readexactly(hsz - len(first))
    except asyncio.IncompleteReadError as e:
        if first or e.partial:
            raise FrameError(
                f"truncated header ({len(first) + len(e.partial)}"
                f"/{hsz} bytes at EOF)", reason="truncated") from e
        raise                    # clean EOF at a frame boundary
    hdr = np.frombuffer(hdr_b, HEADER_DT, count=1)[0]
    magic = int(hdr["magic"])
    if magic not in (MAGIC_PM, MAGIC_MS, MAGIC_NQ):
        raise FrameError(f"bad magic {magic:#x}", reason="bad_magic")
    total = int(hdr["total_sz"])
    if total < hsz or total >= MAX_COMM_DATA_SZ:
        raise FrameError(f"bad total_sz {total}", reason="bad_size")
    padf = int(hdr["padding_sz"])
    pad = padf & 0xFF                # upper bits carry the checksum
    if pad > total - hsz:
        raise FrameError(f"bad padding_sz {pad} (total_sz {total})",
                         reason="bad_size")
    try:
        body = await reader.readexactly(total - hsz)
    except asyncio.IncompleteReadError as e:
        raise FrameError(
            f"truncated frame body ({len(e.partial)}/{total - hsz} "
            f"bytes at EOF)", reason="truncated") from e
    if padf & CHK_FLAG and \
            _xor8(body) != (padf >> _CHK_SHIFT) & 0xFF:
        raise FrameError("payload checksum mismatch", reason="checksum")
    return int(hdr["data_type"]), body[: len(body) - pad]
