"""gy_comm_proto ingest adapter: stock-partha frames → GYT records.

Counterpart of ``gyeeta_tpu/ingest/refproto.py`` (the port's own copy).
The stock partha wire format is the serialization boundary: a stock
partha agent connects unmodified. GYT's own frames are fixed-width and interned
(``wire.py``); the reference's are C++ structs with TRAILING
VARIABLE-LENGTH STRINGS (cmdline / issue strings) and per-record
padding. This module decodes the reference layouts into GYT record
arrays (+ NAME_INTERN announcements for every string), so reference
traffic folds through the exact same ``Runtime.feed`` path.

Layouts transcribed as numpy dtypes from the reference ABI (protocol
contract, little-endian throughout ``gy_comm_proto.h:43``):

- ``COMM_HEADER``           — gy_comm_proto.h:336 (magic/total/type/pad)
- ``EVENT_NOTIFY``          — gy_comm_proto.h:486 (subtype/nevents)
- ``TCP_CONN_NOTIFY``       — gy_comm_proto.h:1665 (+ trailing cmdline)
- ``LISTENER_STATE_NOTIFY`` — gy_comm_proto.h:2183 (+ issue string)
- ``AGGR_TASK_STATE_NOTIFY``— gy_comm_proto.h:2114 (+ issue string)
- ``IP_PORT``/``GY_IP_ADDR``— gy_common_inc.h:11162 / :10492 (packed
  u128 address + u32 v4 + af/flags, 8-aligned, port + tail pad)

Only the partha→madhava event subtypes the engine folds are adapted;
unknown subtypes are skipped frame-whole (forward compatibility — the
reference's recv loop does the same for unhandled events).
"""

from __future__ import annotations

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils.intern import InternTable

# ----------------------------------------------------- reference constants
REF_MAGIC_PS = 0x05555505        # PS_ADHOC_MAGIC (partha → shyama)
REF_MAGIC_PM = 0x05666605        # PM_HDR_MAGIC (partha → madhava)
REF_MAGICS = {0x05555505, 0x05666605, 0x05777705, 0x05888805}

# COMM_TYPE_E (gy_comm_proto.h:124)
REF_COMM_PS_REGISTER_REQ = 2
REF_COMM_PM_CONNECT_CMD = 3
REF_COMM_PS_REGISTER_RESP = 8
REF_COMM_PM_CONNECT_RESP = 9
REF_COMM_EVENT_NOTIFY = 14

REF_NOTIFY_TASK_TOP_PROCS = 0x303
REF_NOTIFY_TASK_AGGR = 0x305
REF_NOTIFY_PING_TASK_AGGR = 0x306
REF_NOTIFY_NEW_LISTENER = 0x307
REF_NOTIFY_LISTENER_STATE = 0x309
REF_NOTIFY_TCP_CONN = 0x30C
REF_NOTIFY_NAT_TCP = 0x30D
REF_NOTIFY_CPU_MEM_STATE = 0x30F
REF_NOTIFY_AGGR_TASK_STATE = 0x310
REF_NOTIFY_PARTHA_STATUS = 0x311
REF_NOTIFY_ACTIVE_CONN_STATS = 0x312
REF_NOTIFY_LISTENER_DOMAIN = 0x313
REF_NOTIFY_LISTEN_TASKMAP = 0x314
REF_NOTIFY_HOST_INFO = 0x317
REF_NOTIFY_HOST_CPU_MEM_CHANGE = 0x318
REF_NOTIFY_NOTIFICATION_MSG = 0x319
REF_NOTIFY_REQ_TRACE_TRAN = 0x31D
REF_NOTIFY_HOST_STATE = 0x31C        # current version (NOTIFY_PM_EVT
#                                      enum order: 0x301 TASK_MINI_ADD
#                                      … 0x31B LISTEN_CLUSTER_INFO,
#                                      0x31C HOST_STATE)

# version encoding: get_version_from_string("a.b.c", 3) = a<<16|b<<8|c
REF_COMM_VERSION = 1             # COMM_VERSION_NUM (gy_comm_proto.h:16)
REF_MIN_PARTHA_VERSION = 0x000400   # "0.4.0" (server/sversion.cc:15)
REF_MADHAVA_VERSION = 0x000502      # presented version (≥ partha's
#                                     gmin_madhava_version "0.5.0")

AF_INET, AF_INET6 = 2, 10

REF_HEADER_DT = np.dtype([       # COMM_HEADER, gy_comm_proto.h:336
    ("magic", "<u4"), ("total_sz", "<u4"),
    ("data_type", "<u4"), ("padding_sz", "<u4"),
])

REF_EVENT_NOTIFY_DT = np.dtype([  # EVENT_NOTIFY, gy_comm_proto.h:486
    ("subtype", "<u4"), ("nevents", "<u4"),
])

# GY_IP_ADDR (gy_common_inc.h:10492, packed+aligned(8)) inside IP_PORT
# (gy_common_inc.h:11162): 16B raw v6 address + embedded v4 + af/flags,
# then the port and 8-align tail padding
REF_IP_PORT_DT = np.dtype([
    ("ip128", "u1", (16,)),      # in6_addr raw bytes (network order)
    ("ip32_be", "<u4"),          # v4 address, network byte order
    ("aftype", "<i2"), ("ipflags", "<u2"),
    ("port", "<u2"), ("pad", "u1", (6,)),
])
assert REF_IP_PORT_DT.itemsize == 32

# TCP_CONN_NOTIFY fixed part (gy_comm_proto.h:1665); cli_cmdline_len_
# bytes of cmdline + padding_len_ bytes follow each record
REF_TCP_CONN_DT = np.dtype([
    ("cli", REF_IP_PORT_DT), ("ser", REF_IP_PORT_DT),
    ("nat_cli", REF_IP_PORT_DT), ("nat_ser", REF_IP_PORT_DT),
    ("tusec_start", "<u8"), ("tusec_close", "<u8"),
    ("cli_task_aggr_id", "<u8"), ("cli_related_listen_id", "<u8"),
    ("cli_madhava_id", "<u8"),
    ("machid_hi", "<u8"), ("machid_lo", "<u8"),   # GY_MACHINE_ID pair
    ("ser_related_listen_id", "<u8"), ("ser_glob_id", "<u8"),
    ("ser_madhava_id", "<u8"),
    ("bytes_sent", "<u8"), ("bytes_rcvd", "<u8"),
    ("cli_pid", "<i4"), ("ser_pid", "<i4"),
    ("ser_conn_hash", "<u4"), ("ser_sock_inode", "<u4"),
    ("cli_comm", "S16"), ("ser_comm", "S16"),
    ("cli_cmdline_len", "<u2"),
    ("is_connect", "u1"), ("is_accept", "u1"), ("is_loopback", "u1"),
    ("is_pre_existing", "u1"), ("notified_before", "u1"),
    ("padding_len", "u1"),
])
assert REF_TCP_CONN_DT.itemsize == 280

# LISTENER_STATE_NOTIFY fixed part (gy_comm_proto.h:2183)
REF_LISTENER_STATE_DT = np.dtype([
    ("glob_id", "<u8"),
    ("nqrys_5s", "<u4"), ("total_resp_5sec", "<u4"), ("nconns", "<u4"),
    ("nconns_active", "<u4"), ("ntasks", "<u4"),
    ("p95_5s_resp_ms", "<u4"), ("p95_5min_resp_ms", "<u4"),
    ("curr_kbytes_inbound", "<u4"), ("curr_kbytes_outbound", "<u4"),
    ("ser_errors", "<u4"), ("cli_errors", "<u4"),
    ("tasks_delay_usec", "<u4"), ("tasks_cpudelay_usec", "<u4"),
    ("tasks_blkiodelay_usec", "<u4"), ("tasks_user_cpu", "<u4"),
    ("tasks_sys_cpu", "<u4"), ("tasks_rss_mb", "<u4"),
    ("ntasks_issue", "<u2"),
    ("is_http_svc", "u1"), ("curr_state", "u1"), ("curr_issue", "u1"),
    ("issue_bit_hist", "u1"), ("high_resp_bit_hist", "u1"),
    ("last_issue_subsrc", "u1"), ("query_flags", "u1"),
    ("issue_string_len", "u1"), ("padding_len", "u1"),
    ("tailpad", "u1", (1,)),
])
assert REF_LISTENER_STATE_DT.itemsize == 88

# AGGR_TASK_STATE_NOTIFY fixed part (gy_comm_proto.h:2114)
REF_AGGR_TASK_DT = np.dtype([
    ("aggr_task_id", "<u8"), ("onecomm", "S16"),
    ("pid_arr", "<i4", (2,)),
    ("tcp_kbytes", "<u4"), ("tcp_conns", "<u4"),
    ("total_cpu_pct", "<f4"), ("rss_mb", "<u4"),
    ("cpu_delay_msec", "<u4"), ("vm_delay_msec", "<u4"),
    ("blkio_delay_msec", "<u4"),
    ("ntasks_total", "<u2"), ("ntasks_issue", "<u2"),
    ("curr_state", "u1"), ("curr_issue", "u1"),
    ("issue_bit_hist", "u1"), ("severe_issue_bit_hist", "u1"),
    ("issue_string_len", "u1"), ("padding_len", "u1"),
    ("tailpad", "u1", (2,)),
])
assert REF_AGGR_TASK_DT.itemsize == 72

# NEW_LISTENER fixed part (gy_comm_proto.h:1531); cmdline_len_ bytes of
# cmdline + padding_len_ bytes follow each record. ns_ip_port_ is
# NS_IP_PORT (gy_inet_inc.h:105): IP_PORT + the listener netns inode.
REF_NEW_LISTENER_DT = np.dtype([
    ("ns_ip_port", REF_IP_PORT_DT), ("inode", "<u8"),
    ("glob_id", "<u8"), ("aggr_glob_id", "<u8"),
    ("related_listen_id", "<u8"), ("tstart_usec", "<u8"),
    ("ser_aggr_task_id", "<u8"),
    ("is_any_ip", "u1"), ("is_pre_existing", "u1"),
    ("no_aggr_stats", "u1"), ("no_resp_stats", "u1"),
    ("comm", "S16"), ("start_pid", "<i4"),
    ("cmdline_len", "<u2"), ("padding_len", "u1"),
    ("tailpad", "u1", (5,)),
])
assert REF_NEW_LISTENER_DT.itemsize == 112

# ACTIVE_CONN_STATS (gy_comm_proto.h:2766) — fixed-size aggregate of one
# (listener, client process-group) pair's active traffic
REF_ACTIVE_CONN_DT = np.dtype([
    ("listener_glob_id", "<u8"), ("cli_aggr_task_id", "<u8"),
    ("ser_comm", "S16"), ("cli_comm", "S16"),
    ("machid_hi", "<u8"), ("machid_lo", "<u8"),
    ("remote_madhava_id", "<u8"),
    ("bytes_sent", "<u8"), ("bytes_received", "<u8"),
    ("cli_delay_msec", "<u4"), ("ser_delay_msec", "<u4"),
    ("max_rtt_msec", "<f4"),
    ("active_conns", "<u2"),
    ("connflags", "u1"),          # bit0 cli_listener_proc, bit1
    #                               is_remote_listen, bit2 is_remote_cli
    ("tailpad", "u1", (1,)),
])
assert REF_ACTIVE_CONN_DT.itemsize == 104

# TASK_TOP_PROCS (gy_comm_proto.h:1415): one 16B header then four
# variable-count arrays of fixed-size entries
REF_TOP_HDR_DT = np.dtype([
    ("nprocs", "<u2"), ("npg_procs", "<u2"), ("nrss_procs", "<u2"),
    ("nfork_procs", "<u2"), ("ext_data_len", "<u2"),
    ("tailpad", "u1", (6,)),
])
REF_TOP_TASK_DT = np.dtype([
    ("aggr_task_id", "<u8"), ("pid", "<i4"), ("ppid", "<i4"),
    ("rss_mb", "<u4"), ("cpupct", "<f4"), ("comm", "S16"),
])
REF_TOP_PG_DT = np.dtype([
    ("aggr_task_id", "<u8"), ("pg_pid", "<i4"), ("cpid", "<i4"),
    ("ntasks", "<i4"), ("tot_rss_mb", "<u4"), ("tot_cpupct", "<f4"),
    ("pg_comm", "S16"), ("child_comm", "S16"), ("tailpad", "u1", (4,)),
])
REF_TOP_FORK_DT = np.dtype([
    ("aggr_task_id", "<u8"), ("pid", "<i4"), ("ppid", "<i4"),
    ("nfork_per_sec", "<i4"), ("comm", "S16"), ("tailpad", "u1", (4,)),
])
assert REF_TOP_HDR_DT.itemsize == 16
assert REF_TOP_TASK_DT.itemsize == 40
assert REF_TOP_PG_DT.itemsize == 64
assert REF_TOP_FORK_DT.itemsize == 40

# ------------------------------------------------ registration handshake
# PS_REGISTER_REQ_S (gy_comm_proto.h:584) — partha's opener to shyama
REF_PS_REGISTER_REQ_DT = np.dtype([
    ("comm_version", "<u4"), ("partha_version", "<u4"),
    ("min_shyama_version", "<u4"), ("pad0", "u1", (4,)),
    ("machine_id_hi", "<u8"), ("machine_id_lo", "<u8"),
    ("hostname", "S256"), ("write_access_key", "S64"),
    ("cluster_name", "S64"), ("region_name", "S64"),
    ("zone_name", "S64"),
    ("kern_version_num", "<u4"), ("pad1", "u1", (4,)),
    ("curr_sec", "<i8"), ("last_mdisconn_sec", "<i8"),
    ("last_madhava_id", "<u8"), ("flags", "<u8"),
    ("extra_bytes", "u1", (512,)),
])
assert REF_PS_REGISTER_REQ_DT.itemsize == 1096

# PS_REGISTER_RESP_S (gy_comm_proto.h:616) — points partha at a madhava
REF_PS_REGISTER_RESP_DT = np.dtype([
    ("error_code", "<i4"), ("error_string", "S256"),
    ("comm_version", "<u4"), ("shyama_version", "<u4"),
    ("pad0", "u1", (4,)),
    ("shyama_id", "<u8"), ("flags", "<u8"),
    ("partha_ident_key", "<u8"), ("madhava_expiry_sec", "<i8"),
    ("madhava_id", "<u8"), ("madhava_port", "<u2"),
    ("madhava_hostname", "S256"), ("madhava_name", "S64"),
    ("extra_bytes", "u1", (800,)), ("tailpad", "u1", (6,)),
])
assert REF_PS_REGISTER_RESP_DT.itemsize == 1440

# PM_CONNECT_CMD_S (gy_comm_proto.h:648) — partha's opener to madhava
REF_PM_CONNECT_CMD_DT = np.dtype([
    ("comm_version", "<u4"), ("partha_version", "<u4"),
    ("min_madhava_version", "<u4"), ("pad0", "u1", (4,)),
    ("machine_id_hi", "<u8"), ("machine_id_lo", "<u8"),
    ("partha_ident_key", "<u8"),
    ("hostname", "S256"), ("write_access_key", "S64"),
    ("cluster_name", "S64"), ("region_name", "S64"),
    ("zone_name", "S64"),
    ("madhava_id", "<u8"), ("cli_type", "<u4"),
    ("kern_version_num", "<u4"),
    ("curr_sec", "<i8"), ("clock_sec", "<i8"),
    ("process_uptime_sec", "<i8"), ("last_connect_sec", "<i8"),
    ("flags", "<u8"), ("extra_bytes", "u1", (512,)),
])
assert REF_PM_CONNECT_CMD_DT.itemsize == 1120

# PM_CONNECT_RESP_S (gy_comm_proto.h:691)
REF_PM_CONNECT_RESP_DT = np.dtype([
    ("error_code", "<i4"), ("error_string", "S256"),
    ("pad0", "u1", (4,)),
    ("madhava_id", "<u8"), ("comm_version", "<u4"),
    ("madhava_version", "<u4"),
    ("region_name", "S64"), ("zone_name", "S64"),
    ("madhava_name", "S64"),
    ("curr_sec", "<i8"), ("clock_sec", "<u8"), ("flags", "<u8"),
    ("extra_bytes", "u1", (512,)),
])
assert REF_PM_CONNECT_RESP_DT.itemsize == 1008

# CLI_TYPE_E (gy_comm_proto.h:91)
REF_CLI_TYPE_REQ_RESP = 0
REF_CLI_TYPE_REQ_ONLY = 1

_HSZ = REF_HEADER_DT.itemsize
_ESZ = REF_EVENT_NOTIFY_DT.itemsize


# CPU_MEM_STATE_NOTIFY fixed part (gy_comm_proto.h:2024, 200 bytes);
# cpu_state_string_len_ + mem_state_string_len_ bytes of state strings
# + padding_len_ follow each record
REF_CPU_MEM_DT = np.dtype([
    ("cpu_pct", "<f4"), ("usercpu_pct", "<f4"), ("syscpu_pct", "<f4"),
    ("iowait_pct", "<f4"), ("cumul_core_cpu_pct", "<f4"),
    ("forks_sec", "<u4"), ("procs_running", "<u4"), ("cs_sec", "<u4"),
    ("cs_p95_sec", "<u4"), ("cs_5min_p95_sec", "<u4"),
    ("cpu_p95", "<u4"), ("cpu_5min_p95", "<u4"),
    ("fork_p95_sec", "<u4"), ("fork_5min_p95_sec", "<u4"),
    ("procs_p95", "<u4"), ("procs_5min_p95", "<u4"),
    ("cpu_state", "u1"), ("cpu_issue", "u1"),
    ("cpu_issue_bit_hist", "u1"), ("cpu_severe_issue_hist", "u1"),
    ("cpu_state_string_len", "u1"), ("pad0", "u1", (3,)),
    ("rss_pct", "<f4"), ("pad1", "u1", (4,)),
    ("rss_memory_mb", "<u8"), ("total_memory_mb", "<u8"),
    ("cached_memory_mb", "<u8"), ("locked_memory_mb", "<u8"),
    ("committed_memory_mb", "<u8"),
    ("committed_pct", "<f4"), ("pad2", "u1", (4,)),
    ("swap_free_mb", "<u8"), ("swap_total_mb", "<u8"),
    ("pg_inout_sec", "<u4"), ("swap_inout_sec", "<u4"),
    ("reclaim_stalls", "<u4"), ("pgmajfault", "<u4"),
    ("oom_kill", "<u4"), ("rss_pct_p95", "<u4"),
    ("pginout_p95", "<u8"), ("swpinout_p95", "<u8"),
    ("allocstall_p95", "<u8"),
    ("mem_state", "u1"), ("mem_issue", "u1"),
    ("mem_issue_bit_hist", "u1"), ("mem_severe_issue_hist", "u1"),
    ("mem_state_string_len", "u1"), ("padding_len", "u1"),
    ("tailpad", "u1", (2,)),
])
assert REF_CPU_MEM_DT.itemsize == 200

# HOST_STATE_NOTIFY (gy_comm_proto.h:2289, 56 bytes, nevents == 1)
REF_HOST_STATE_DT = np.dtype([
    ("curr_time_usec", "<u8"),
    ("ntasks_issue", "<u4"), ("ntasks_severe", "<u4"),
    ("ntasks", "<u4"),
    ("nlisten_issue", "<u4"), ("nlisten_severe", "<u4"),
    ("nlisten", "<u4"),
    ("curr_state", "u1"), ("issue_bit_hist", "u1"),
    ("cpu_issue", "u1"), ("mem_issue", "u1"),
    ("severe_cpu_issue", "u1"), ("severe_mem_issue", "u1"),
    ("pad0", "u1", (2,)),
    ("total_cpu_delayms", "<u4"), ("total_vm_delayms", "<u4"),
    ("total_io_delayms", "<u4"), ("tailpad", "u1", (4,)),
])
assert REF_HOST_STATE_DT.itemsize == 56

# HOST_INFO_NOTIFY (gy_comm_proto.h:2844, 704 bytes, nevents == 1)
REF_HOST_INFO_DT = np.dtype([
    ("distribution_name", "S128"), ("kern_version_string", "S64"),
    ("kern_version_num", "<u4"), ("instance_id", "S128"),
    ("cloud_type", "S64"), ("processor_model", "S128"),
    ("cpu_vendor", "S64"),
    ("cores_online", "<u2"), ("cores_offline", "<u2"),
    ("max_cores", "<u2"), ("isolated_cores", "<u2"),
    ("ram_mb", "<u4"), ("corrupted_ram_mb", "<u4"),
    ("num_numa_nodes", "<u2"), ("max_cores_per_socket", "<u2"),
    ("threads_per_core", "<u2"), ("pad0", "u1", (6,)),
    ("boot_time_sec", "<i8"),
    ("l1_dcache_kb", "<u4"), ("l2_cache_kb", "<u4"),
    ("l3_cache_kb", "<u4"), ("l4_cache_kb", "<u4"),
    ("is_virtual_cpu", "u1"), ("virtualization_type", "S64"),
    ("tailpad", "u1", (7,)),
])
assert REF_HOST_INFO_DT.itemsize == 704

# NAT_TCP_NOTIFY (gy_comm_proto.h:1744, 136 bytes): conntrack
# orig↔nat tuple pairs resolved AFTER the conn notify
REF_NAT_TCP_DT = np.dtype([
    ("orig_cli", REF_IP_PORT_DT), ("orig_ser", REF_IP_PORT_DT),
    ("nat_cli", REF_IP_PORT_DT), ("nat_ser", REF_IP_PORT_DT),
    ("is_snat", "u1"), ("is_dnat", "u1"), ("is_ipvs", "u1"),
    ("tailpad", "u1", (5,)),
])
assert REF_NAT_TCP_DT.itemsize == 136

# REQ_TRACE_TRAN / API_TRAN (gy_proto_common.h:140, 176 bytes fixed;
# request_len_ bytes of request text + lenext_ ext fields + padlen_
# follow each record) — the reference's request-trace stream
REF_GY_IP_ADDR_DT = np.dtype([
    ("ip128", "u1", (16,)), ("ip32_be", "<u4"),
    ("aftype", "<i2"), ("ipflags", "<u2"),
])
assert REF_GY_IP_ADDR_DT.itemsize == 24
REF_API_TRAN_DT = np.dtype([
    ("treq_usec", "<u8"), ("tres_usec", "<u8"), ("tupd_usec", "<u8"),
    ("reqlen", "<u8"), ("reslen", "<u8"), ("reqnum", "<u8"),
    ("response_usec", "<u8"), ("reaction_usec", "<u8"),
    ("tconnect_usec", "<u8"),
    ("cliip", REF_GY_IP_ADDR_DT), ("serip", REF_GY_IP_ADDR_DT),
    ("glob_id", "<u8"), ("conn_id", "<u8"),
    ("comm", "S16"),
    ("errorcode", "<i4"), ("app_sleep_ms", "<u4"),
    ("tran_type", "<u4"),
    ("proto", "<u2"), ("cliport", "<u2"), ("serport", "<u2"),
    ("request_len", "<u2"), ("lenext", "<u2"),
    ("padlen", "u1"), ("tailpad", "u1", (1,)),
])
assert REF_API_TRAN_DT.itemsize == 176

# reference PROTO_TYPES (gy_proto_common.h:14) → GYT trace protos
_REF_PROTO_MAP = {1: 1, 2: 4, 3: 2, 5: 3, 7: 6}   # HTTP1, HTTP2,
#                 Postgres, Mongo, Sybase; others → 0 (unknown)

# PING_TASK_AGGR (gy_comm_proto.h:1384, 8 bytes): process-group
# keepalive — long-lived quiet groups refresh their ageing clock
# without a stats sweep (the madhava refreshes last_tick and never
# inserts; MAX_NUM_PINGS = 2048)
REF_PING_TASK_AGGR_DT = np.dtype([
    ("aggr_task_id", "<u8"),
])
assert REF_PING_TASK_AGGR_DT.itemsize == 8

# PARTHA_STATUS (gy_comm_proto.h:1399, 24 bytes, nevents == 1): the
# partha's liveness ping (is_ok + clock skew sample) — session-level,
# never engine-fed
REF_PARTHA_STATUS_DT = np.dtype([
    ("is_ok", "u1"), ("pad0", "u1", (7,)),
    ("curr_sec", "<i8"), ("clock_sec", "<i8"),
])
assert REF_PARTHA_STATUS_DT.itemsize == 24

# TASK_AGGR_NOTIFY (gy_comm_proto.h:1290, 48 bytes + cmdline/tag):
# process-group announcements carrying the task→listener linkage
REF_TASK_AGGR_DT = np.dtype([
    ("aggr_task_id", "<u8"), ("related_listen_id", "<u8"),
    ("comm", "S16"), ("uid", "<u4"), ("gid", "<u4"),
    ("cmdline_len", "<u2"), ("tag_len", "u1"), ("procflags", "u1"),
    ("padding_len", "u1"), ("tailpad", "u1", (3,)),
])
assert REF_TASK_AGGR_DT.itemsize == 48

# HOST_CPU_MEM_CHANGE (gy_comm_proto.h:2886, 32 bytes, nevents == 1)
REF_CPU_MEM_CHANGE_DT = np.dtype([
    ("cpu_changed", "u1"), ("pad0", "u1"),
    ("new_cores_online", "<u2"), ("new_cores_offline", "<u2"),
    ("old_cores_online", "<u2"), ("old_cores_offline", "<u2"),
    ("mem_changed", "u1"), ("pad1", "u1"),
    ("new_ram_mb", "<u4"), ("old_ram_mb", "<u4"),
    ("mem_corrupt_changed", "u1"), ("pad2", "u1", (3,)),
    ("new_corrupted_ram_mb", "<u4"), ("old_corrupted_ram_mb", "<u4"),
])
assert REF_CPU_MEM_CHANGE_DT.itemsize == 32

# NOTIFICATION_MSG (gy_comm_proto.h:2913, 8 bytes + msglen_ text)
REF_NOTIFICATION_MSG_DT = np.dtype([
    ("type", "u1"), ("pad0", "u1"), ("msglen", "<u2"),
    ("padding_len", "u1"), ("tailpad", "u1", (3,)),
])
assert REF_NOTIFICATION_MSG_DT.itemsize == 8
_REF_MSGTYPES = {0: "info", 1: "warn", 2: "error", 3: "error"}

# LISTENER_DOMAIN_NOTIFY (gy_comm_proto.h:2724, 16 bytes + domain/tag)
REF_LISTENER_DOMAIN_DT = np.dtype([
    ("glob_id", "<u8"),
    ("domain_string_len", "u1"), ("tag_len", "u1"),
    ("padding_len", "u1"), ("tailpad", "u1", (5,)),
])
assert REF_LISTENER_DOMAIN_DT.itemsize == 16


# LISTEN_TASKMAP_NOTIFY fixed part (gy_comm_proto.h:2813); nlisten_
# u64 listener glob ids then naggr u64 task ids follow each record
REF_LISTEN_TASKMAP_DT = np.dtype([
    ("related_listen_id", "<u8"), ("ser_comm", "S16"),
    ("nlisten", "<u2"), ("naggr_taskid", "<u2"),
    ("tailpad", "u1", (4,)),
])
assert REF_LISTEN_TASKMAP_DT.itemsize == 32


class RefFrameError(wire.FrameError):
    pass


class RefSession:
    """Per-connection adapter state for a stock-partha stream.

    The reference resolves task↔listener linkage server-side from
    LISTEN_TASKMAP events (``gy_comm_proto.h:2813``); this holds that
    map so subsequent AGGR_TASK_STATE records carry their
    ``related_listen_id`` (without it, stock task rows never link to
    their services — taskstate.relsvcid / svcprocmap would stay
    empty for stock fleets). Bounded: newest mappings win."""

    MAX_TASKS = 1 << 20

    def __init__(self, region: str = "", zone: str = ""):
        self.rel_of_task: dict = {}
        self.ncpus = 0               # estimated core count (cpu_mem)
        # cluster placement from the PM_CONNECT handshake (HOST_INFO
        # itself does not carry region/zone — the wire does)
        self.region = region
        self.zone = zone
        # frameless notify payloads collected for the serving edge
        # (bounded; the edge drains them after every adapt run)
        self.notifications: list = []    # (ntype_str, message)
        self.domains: list = []          # (glob_id, domain, tag)
        # adaptation observability: events per reference subtype
        # (drained into selfstats as ref_evt_0x<subtype> counters) +
        # frames skipped whole (unknown subtype, non-NOTIFY data
        # types, truncated NOTIFY bodies)
        import collections
        self.n_events = collections.Counter()   # subtype -> count
        self.n_skipped = 0
        self.nat_conns: list = []        # TCP_CONN record arrays (NAT
        #                                  annotations for the VIP
        #                                  registry; never engine-fed)
        # PARTHA_STATUS liveness: (is_ok, curr_sec) of the newest ping
        # (the serving edge surfaces not-ok transitions)
        self.last_status_ok = True
        self.last_status_sec = 0

    # drained by the serving edge after each adapt() run
    MAX_PENDING = 1024

    def _push(self, lst: list, item) -> None:
        if len(lst) < self.MAX_PENDING:
            lst.append(item)

    def learn_taskmap(self, rel_id: int, task_ids) -> None:
        for t in task_ids:
            if len(self.rel_of_task) >= self.MAX_TASKS \
                    and int(t) not in self.rel_of_task:
                self.rel_of_task.clear()     # epoch reset, re-learns
            self.rel_of_task[int(t)] = rel_id


def _check_nevents(nevents: int, payload: bytes, fsz: int, cap: int,
                   what: str) -> None:
    """The wire's u4 nevents is attacker-controlled: bound it by the
    reference batch cap AND by what the payload could possibly hold
    (each record is ≥ fsz bytes) BEFORE allocating output — the GYT
    decoder enforces the same caps in ``wire.decode_frames``."""
    if nevents > cap or nevents * fsz > len(payload):
        raise RefFrameError(
            f"{what}: nevents {nevents} exceeds cap {cap} or "
            f"payload {len(payload)}B")


def _ip16(rec) -> bytes:
    """One REF_IP_PORT → the wire's 16-byte (v4-mapped) address."""
    if int(rec["aftype"]) == AF_INET:
        return (b"\x00" * 10 + b"\xff\xff"
                + int(rec["ip32_be"]).to_bytes(4, "little"))
        # ip32_be_ holds network-order bytes; little-endian re-pack of
        # the u32 value restores the original byte sequence
    return rec["ip128"].tobytes()


def _copy_ip_port(dst, src) -> None:
    dst["ip"] = np.frombuffer(_ip16(src), np.uint8)
    dst["port"] = src["port"]


def decode_tcp_conn(payload: bytes, nevents: int, host_id: int
                    ) -> tuple[np.ndarray, list]:
    """Variable-length TCP_CONN_NOTIFY walk → GYT TCP_CONN records +
    intern entries for comm/cmdline strings."""
    fsz = REF_TCP_CONN_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_CONNS_PER_BATCH,
                   "tcp_conn")
    out = np.zeros(nevents, wire.TCP_CONN_DT)
    names: list = []
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"tcp_conn record {i} truncated")
        rec = np.frombuffer(payload, REF_TCP_CONN_DT, count=1,
                            offset=off)[0]
        cmdlen = int(rec["cli_cmdline_len"])
        end = off + fsz + cmdlen + int(rec["padding_len"])
        if end > len(payload):
            raise RefFrameError(f"tcp_conn record {i} overflows frame")
        r = out[i]
        for f in ("cli", "ser", "nat_cli", "nat_ser"):
            _copy_ip_port(r[f], rec[f])
        for f in ("tusec_start", "tusec_close", "cli_task_aggr_id",
                  "cli_related_listen_id", "cli_madhava_id",
                  "ser_related_listen_id", "ser_glob_id",
                  "ser_madhava_id", "bytes_sent", "bytes_rcvd",
                  "cli_pid", "ser_pid", "ser_conn_hash",
                  "ser_sock_inode"):
            r[f] = rec[f]
        r["peer_machine_id_hi"] = rec["machid_hi"]
        r["peer_machine_id_lo"] = rec["machid_lo"]
        for src_f, dst_f in (("cli_comm", "cli_comm_id"),
                             ("ser_comm", "ser_comm_id")):
            s = rec[src_f].tobytes().split(b"\x00", 1)[0].decode(
                "utf-8", "replace")
            if s:
                nid = InternTable.intern(s, wire.NAME_KIND_COMM)
                r[dst_f] = nid
                names.append((wire.NAME_KIND_COMM, nid, s))
        if cmdlen:
            cmdline = payload[off + fsz: off + fsz + cmdlen].split(
                b"\x00", 1)[0].decode("utf-8", "replace")
            nid = InternTable.intern(cmdline, wire.NAME_KIND_MISC)
            r["cli_cmdline_id"] = nid
            names.append((wire.NAME_KIND_MISC, nid, cmdline))
        r["host_id"] = host_id
        r["flags"] = (int(rec["is_connect"]) * 1
                      | int(rec["is_accept"]) * 2
                      | int(rec["is_loopback"]) * 4
                      | int(rec["is_pre_existing"]) * 8
                      | int(rec["notified_before"]) * 16)
        off = end
    return out, names


def decode_listener_state(payload: bytes, nevents: int, host_id: int
                          ) -> tuple[np.ndarray, list]:
    fsz = REF_LISTENER_STATE_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_LISTENERS_PER_BATCH,
                   "listener_state")
    out = np.zeros(nevents, wire.LISTENER_STATE_DT)
    names: list = []
    off = 0
    shared = set(wire.LISTENER_STATE_DT.names) \
        & set(REF_LISTENER_STATE_DT.names)
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"listener_state record {i} truncated")
        rec = np.frombuffer(payload, REF_LISTENER_STATE_DT, count=1,
                            offset=off)[0]
        ilen = int(rec["issue_string_len"])
        end = off + fsz + ilen + int(rec["padding_len"])
        if end > len(payload):
            raise RefFrameError(
                f"listener_state record {i} overflows frame")
        r = out[i]
        for f in shared:
            if f != "pad":
                r[f] = rec[f]
        if ilen:
            s = payload[off + fsz: off + fsz + ilen].split(
                b"\x00", 1)[0].decode("utf-8", "replace")
            nid = InternTable.intern(s, wire.NAME_KIND_MISC)
            r["issue_string_id"] = nid
            names.append((wire.NAME_KIND_MISC, nid, s))
        r["host_id"] = host_id
        off = end
    return out, names


def decode_cpu_mem(payload: bytes, nevents: int, host_id: int,
                   session: "RefSession | None" = None
                   ) -> tuple[np.ndarray, list]:
    """CPU_MEM_STATE_NOTIFY walk → GYT CPU_MEM records (2s host
    gauges; state strings skipped — the engine classifies itself).

    Semantic mapping caveats (the struct carries neither per-core
    maxima nor a core count):
    - ``cumul_core_cpu_pct_`` is the SUM across cores (can exceed
      100); GYT's ``max_core_cpu_pct`` (hottest core) falls back to
      the host average ``cpu_pct`` — conservative: a saturated single
      core is under-reported, a healthy multi-core host is never
      false-flagged.
    - ``ncpus`` (classifier thresholds scale with it) is ESTIMATED as
      round(sum/average) when the host is busy enough for the ratio
      to be stable (≥5% cpu), cached on the session."""
    fsz = REF_CPU_MEM_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_CPUMEM_PER_BATCH,
                   "cpu_mem")
    out = np.zeros(nevents, wire.CPU_MEM_DT)
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"cpu_mem record {i} truncated")
        rec = np.frombuffer(payload, REF_CPU_MEM_DT, count=1,
                            offset=off)[0]
        end = (off + fsz + int(rec["cpu_state_string_len"])
               + int(rec["mem_state_string_len"])
               + int(rec["padding_len"]))
        if end > len(payload):
            raise RefFrameError(f"cpu_mem record {i} overflows")
        r = out[i]
        for f in ("cpu_pct", "usercpu_pct", "syscpu_pct",
                  "iowait_pct", "cs_sec", "forks_sec",
                  "procs_running", "rss_pct", "pg_inout_sec",
                  "swap_inout_sec"):
            r[f] = rec[f]
        cpu = float(rec["cpu_pct"])
        if session is not None and cpu >= 5.0:
            session.ncpus = max(1, round(
                float(rec["cumul_core_cpu_pct"]) / cpu))
        r["ncpus"] = session.ncpus if session is not None else 0
        r["max_core_cpu_pct"] = cpu          # see docstring caveat
        r["commit_pct"] = rec["committed_pct"]
        tot_swap = float(rec["swap_total_mb"])
        r["swap_free_pct"] = (100.0 * float(rec["swap_free_mb"])
                              / tot_swap) if tot_swap else 100.0
        r["allocstall_sec"] = rec["reclaim_stalls"]
        r["oom_kills"] = rec["oom_kill"]
        r["host_id"] = host_id
        off = end
    return out, []


def decode_host_state(payload: bytes, nevents: int, host_id: int
                      ) -> tuple[np.ndarray, list]:
    """HOST_STATE_NOTIFY → GYT HOST_STATE records (fixed size)."""
    fsz = REF_HOST_STATE_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_HOSTS_PER_BATCH,
                   "host_state")
    recs = np.frombuffer(payload, REF_HOST_STATE_DT, count=nevents)
    out = np.zeros(nevents, wire.HOST_STATE_DT)
    for f in ("curr_time_usec", "ntasks_issue", "ntasks_severe",
              "ntasks", "nlisten_issue", "nlisten_severe", "nlisten",
              "curr_state", "issue_bit_hist", "cpu_issue", "mem_issue",
              "severe_cpu_issue", "severe_mem_issue"):
        out[f] = recs[f]
    out["host_id"] = host_id
    return out, []


def decode_host_info(payload: bytes, nevents: int, host_id: int,
                     session: "RefSession | None" = None
                     ) -> tuple[np.ndarray, list]:
    """HOST_INFO_NOTIFY → GYT HOST_INFO records + interned strings
    (the hostinfo inventory view for stock fleets). Region/zone come
    from the session (the PM_CONNECT handshake carries them; this
    struct does not)."""
    fsz = REF_HOST_INFO_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_HOST_INFO_PER_BATCH,
                   "host_info")
    recs = np.frombuffer(payload, REF_HOST_INFO_DT, count=nevents)
    out = np.zeros(nevents, wire.HOST_INFO_DT)
    names: list = []
    for i in range(nevents):
        rec = recs[i]
        r = out[i]
        r["ncpus"] = rec["cores_online"]
        r["nnuma"] = max(int(rec["num_numa_nodes"]), 1)
        r["ram_mb"] = rec["ram_mb"]
        # wire value is attacker-controlled: clamp into the unsigned
        # usec field instead of letting numpy raise OverflowError
        boot = int(rec["boot_time_sec"])
        r["boot_tusec"] = min(max(boot, 0), (1 << 63) // 10**6) \
            * 1_000_000
        region = session.region if session is not None else ""
        zone = session.zone if session is not None else ""
        for val, dst in ((_cstr(rec["kern_version_string"]),
                          "kern_ver_id"),
                         (_cstr(rec["distribution_name"]), "distro_id"),
                         (_cstr(rec["processor_model"]), "cputype_id"),
                         (_cstr(rec["instance_id"]), "instance_id"),
                         (region, "region_id"), (zone, "zone_id")):
            nid = InternTable.intern(val, wire.NAME_KIND_MISC)
            r[dst] = nid
            names.append((wire.NAME_KIND_MISC, nid, val))
        cloud = _cstr(rec["cloud_type"]).lower()
        r["cloud_type"] = (1 if "aws" in cloud else
                           2 if "gcp" in cloud or "google" in cloud
                           else 3 if "azure" in cloud else 0)
        virt = _cstr(rec["virtualization_type"]).lower()
        r["virt_type"] = (2 if any(m in virt for m in
                                   ("docker", "lxc", "container",
                                    "podman")) else
                          1 if rec["is_virtual_cpu"] else 0)
        r["host_id"] = host_id
    return out, names


def decode_listen_taskmap(payload: bytes, nevents: int,
                          session: "RefSession") -> None:
    """LISTEN_TASKMAP walk → session task→listener map (no GYT frames;
    linkage applies to later AGGR_TASK_STATE records)."""
    fsz = REF_LISTEN_TASKMAP_DT.itemsize
    _check_nevents(nevents, payload, fsz, 2048, "listen_taskmap")
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"listen_taskmap record {i} truncated")
        rec = np.frombuffer(payload, REF_LISTEN_TASKMAP_DT, count=1,
                            offset=off)[0]
        nl, na = int(rec["nlisten"]), int(rec["naggr_taskid"])
        if nl > 2048 or na > 128:        # the reference's own caps
            raise RefFrameError(f"listen_taskmap record {i} overflows")
        end = off + fsz + (nl + na) * 8
        if end > len(payload):
            raise RefFrameError(f"listen_taskmap record {i} overflows")
        tasks = np.frombuffer(payload, "<u8", count=na,
                              offset=off + fsz + nl * 8)
        session.learn_taskmap(int(rec["related_listen_id"]), tasks)
        off = end


def decode_notification_msg(payload: bytes, nevents: int,
                            session: "RefSession") -> None:
    """NOTIFICATION_MSG walk → session notifications (the agent's
    operator messages land in the notifymsg ring)."""
    fsz = REF_NOTIFICATION_MSG_DT.itemsize
    _check_nevents(nevents, payload, fsz, 128, "notification_msg")
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"notification_msg {i} truncated")
        rec = np.frombuffer(payload, REF_NOTIFICATION_MSG_DT, count=1,
                            offset=off)[0]
        ln = int(rec["msglen"])
        end = off + fsz + ln + int(rec["padding_len"])
        if ln > 512 or end > len(payload):
            raise RefFrameError(f"notification_msg {i} overflows")
        msg = payload[off + fsz: off + fsz + ln].split(
            b"\x00", 1)[0].decode("utf-8", "replace")
        if msg:
            session._push(session.notifications,
                          (_REF_MSGTYPES.get(int(rec["type"]), "info"),
                           msg))
        off = end


def decode_listener_domain(payload: bytes, nevents: int,
                           session: "RefSession") -> None:
    """LISTENER_DOMAIN walk → session (glob_id, domain, tag) — the
    serving edge resolves the listener's bind address and primes the
    DNS cache (resolved-AS names for svcipclust annotations)."""
    fsz = REF_LISTENER_DOMAIN_DT.itemsize
    _check_nevents(nevents, payload, fsz, 512, "listener_domain")
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"listener_domain {i} truncated")
        rec = np.frombuffer(payload, REF_LISTENER_DOMAIN_DT, count=1,
                            offset=off)[0]
        dlen, tlen = int(rec["domain_string_len"]), int(rec["tag_len"])
        end = off + fsz + dlen + tlen + int(rec["padding_len"])
        if end > len(payload):
            raise RefFrameError(f"listener_domain {i} overflows")
        dom = payload[off + fsz: off + fsz + dlen].split(
            b"\x00", 1)[0].decode("utf-8", "replace")
        tag = payload[off + fsz + dlen: off + fsz + dlen + tlen].split(
            b"\x00", 1)[0].decode("utf-8", "replace")
        if dom or tag:
            session._push(session.domains,
                          (int(rec["glob_id"]), dom, tag))
        off = end


# NAT_TCP batch cap — the reference's NAT_TCP_NOTIFY::MAX_NUM_CONNS
REF_MAX_NAT_PER_BATCH = 2048


def _ip16_col(tup) -> np.ndarray:
    """(N,) REF_IP_PORT records → (N, 16) wire addresses (v4-mapped
    where aftype is AF_INET) — the vectorized :func:`_ip16`."""
    raw = np.ascontiguousarray(tup["ip128"])
    v4 = np.zeros_like(raw)
    v4[:, 10:12] = 0xFF
    v4[:, 12:16] = np.ascontiguousarray(
        tup["ip32_be"]).view(np.uint8).reshape(-1, 4)
    is4 = (np.ascontiguousarray(tup["aftype"]) == AF_INET)[:, None]
    return np.where(is4, v4, raw)


def decode_req_trace_tran(payload: bytes, nevents: int, host_id: int
                          ) -> tuple[np.ndarray, list]:
    """REQ_TRACE_TRAN walk → GYT REQ_TRACE records + interned API
    signatures.

    The reference streams RAW request text per transaction and
    normalizes server-side; here the request normalizes through the
    SAME :func:`~gyeeta_tpu_torch.trace.proto.normalize_sql`-style signature
    path the local parsers use, so stock-partha traces and
    locally-captured traces aggregate under identical API ids. The
    trace→resp bridge then feeds svcstate latencies for free, and
    error transactions accumulate into ser_errors (the trace fold)."""
    from gyeeta_tpu_torch.trace.proto import normalize_http, normalize_sql
    from gyeeta_tpu_torch.utils import hashing as H

    fsz = REF_API_TRAN_DT.itemsize
    # tolerant cap: the reference producer batches ≤256 (API_TRAN::
    # MAX_NUM_REQS) but our pipeline accepts its own trace batch size
    _check_nevents(nevents, payload, fsz, wire.MAX_TRACE_PER_BATCH,
                   "req_trace_tran")
    out = np.zeros(nevents, wire.REQ_TRACE_DT)
    names: list = []
    seen: dict = {}
    seen_comm: dict = {}
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"req_trace_tran {i} truncated")
        rec = np.frombuffer(payload, REF_API_TRAN_DT, count=1,
                            offset=off)[0]
        rlen = int(rec["request_len"])
        end = (off + fsz + rlen + int(rec["lenext"])
               + int(rec["padlen"]))
        if rlen > 16384 or end > len(payload):
            raise RefFrameError(f"req_trace_tran {i} overflows")
        req_text = payload[off + fsz: off + fsz + rlen].split(
            b"\x00", 1)[0]
        proto = int(rec["proto"])
        if not req_text:
            api = "(empty)"
        elif proto in (1, 2) and b" " in req_text:   # HTTP1/HTTP2:
            meth, _, path = req_text.partition(b" ")  # method + path
            api = normalize_http(meth, path.split(b" ", 1)[0])
        else:
            api = normalize_sql(req_text)
        api_id = seen.get(api)
        if api_id is None:
            # unsalted content hash — the id convention of
            # transactions_to_records (trace/proto.py:292), so stock
            # and locally-parsed traces share API identities
            api_id = int(H.hash_bytes_np(api.encode()))
            seen[api] = api_id
            names.append((wire.NAME_KIND_API, api_id, api))
        r = out[i]
        r["svc_glob_id"] = rec["glob_id"]
        r["api_id"] = api_id
        r["conn_id"] = rec["conn_id"]
        r["tusec"] = rec["treq_usec"]
        r["resp_usec"] = min(int(rec["response_usec"]), 0xFFFFFFFF)
        r["bytes_in"] = min(int(rec["reqlen"]), 0xFFFFFFFF)
        r["bytes_out"] = min(int(rec["reslen"]), 0xFFFFFFFF)
        err = int(rec["errorcode"])
        r["status"] = min(abs(err), 0xFFFF)
        r["is_error"] = err != 0
        r["proto"] = _REF_PROTO_MAP.get(proto, 0)
        r["host_id"] = host_id
        comm = rec["comm"].tobytes().split(b"\x00", 1)[0].decode(
            "utf-8", "replace")
        if comm:
            cid = seen_comm.get(comm)
            if cid is None:            # trace batches repeat one comm:
                cid = InternTable.intern(comm, wire.NAME_KIND_COMM)
                seen_comm[comm] = cid  # dedup the announcements
                names.append((wire.NAME_KIND_COMM, cid, comm))
            r["cli_comm_id"] = cid
        off = end
    return out, names


def decode_ping_task_aggr(payload: bytes, nevents: int, host_id: int
                          ) -> tuple[np.ndarray, list]:
    """PING_TASK_AGGR walk → GYT TASK_PING records (fixed size): the
    keepalive refreshes the group's device-table ageing clock, so
    long-lived quiet stock task rows stop ageing out between 5s
    sweeps (``engine/step.ping_tasks``)."""
    fsz = REF_PING_TASK_AGGR_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_PINGS_PER_BATCH,
                   "ping_task_aggr")
    recs = np.frombuffer(payload, REF_PING_TASK_AGGR_DT, count=nevents)
    out = np.zeros(nevents, wire.TASK_PING_DT)
    out["aggr_task_id"] = recs["aggr_task_id"]
    out["host_id"] = host_id
    return out, []


def decode_partha_status(payload: bytes, nevents: int,
                         session: "RefSession") -> None:
    """PARTHA_STATUS walk → session liveness (frameless): the newest
    ping's (is_ok, curr_sec) lands on the session; ok→not-ok
    transitions raise an operator notification (the reference treats
    these as host liveness for its parthalist views)."""
    fsz = REF_PARTHA_STATUS_DT.itemsize
    _check_nevents(nevents, payload, fsz, 16, "partha_status")
    recs = np.frombuffer(payload, REF_PARTHA_STATUS_DT, count=nevents)
    for rec in recs:
        ok = bool(rec["is_ok"])
        if session.last_status_ok and not ok:
            session._push(session.notifications,
                          ("warn", "partha reports degraded status"))
        session.last_status_ok = ok
        session.last_status_sec = int(rec["curr_sec"])


def decode_task_aggr(payload: bytes, nevents: int,
                     session: "RefSession") -> None:
    """TASK_AGGR walk → session task→listener linkage (a second
    source besides LISTEN_TASKMAP: group announcements carry their
    related_listen_id directly)."""
    fsz = REF_TASK_AGGR_DT.itemsize
    _check_nevents(nevents, payload, fsz, 1200, "task_aggr")
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"task_aggr {i} truncated")
        rec = np.frombuffer(payload, REF_TASK_AGGR_DT, count=1,
                            offset=off)[0]
        end = (off + fsz + int(rec["cmdline_len"])
               + int(rec["tag_len"]) + int(rec["padding_len"]))
        if end > len(payload):
            raise RefFrameError(f"task_aggr {i} overflows")
        rel = int(rec["related_listen_id"])
        if rel:
            session.learn_taskmap(rel, [int(rec["aggr_task_id"])])
        off = end


def decode_cpu_mem_change(payload: bytes, nevents: int,
                          session: "RefSession") -> None:
    """HOST_CPU_MEM_CHANGE → operator notifications (cores on/offline,
    RAM resize, memory corruption — the reference raises the same as
    host notifications)."""
    fsz = REF_CPU_MEM_CHANGE_DT.itemsize
    _check_nevents(nevents, payload, fsz, 16, "cpu_mem_change")
    recs = np.frombuffer(payload, REF_CPU_MEM_CHANGE_DT, count=nevents)
    for rec in recs:
        if rec["cpu_changed"]:
            session._push(session.notifications, (
                "warn", f"host cores changed: "
                f"{int(rec['old_cores_online'])} → "
                f"{int(rec['new_cores_online'])} online"))
        if rec["mem_changed"]:
            session._push(session.notifications, (
                "warn", f"host RAM changed: {int(rec['old_ram_mb'])}"
                f" → {int(rec['new_ram_mb'])} MB"))
        if rec["mem_corrupt_changed"]:
            session._push(session.notifications, (
                "error", f"corrupted RAM changed: "
                f"{int(rec['old_corrupted_ram_mb'])} → "
                f"{int(rec['new_corrupted_ram_mb'])} MB"))


def decode_nat_tcp(payload: bytes, nevents: int,
                   session: "RefSession") -> None:
    """NAT_TCP walk → session NAT annotations.

    Conntrack resolves some translations AFTER the conn notify; the
    reference fixes the conn up server-side. Here the DNAT/IPVS pairs
    become synthetic TCP_CONN records carrying ONLY tuple fields
    (ser = the dialed VIP, nat_* = the translated tuple,
    ser_glob_id = 0) for the VIP/NAT cluster registry — never
    engine-fed, so no phantom connections are counted. Pure-SNAT
    records (server tuple unchanged) are dropped: registering a
    service's own address as its "VIP" would fabricate self-clusters
    and eat the bounded registry."""
    fsz = REF_NAT_TCP_DT.itemsize
    _check_nevents(nevents, payload, fsz, REF_MAX_NAT_PER_BATCH,
                   "nat_tcp")
    recs = np.frombuffer(payload, REF_NAT_TCP_DT, count=nevents)
    ser_ip = _ip16_col(recs["orig_ser"])
    nat_ser_ip = _ip16_col(recs["nat_ser"])
    translated = ((recs["is_dnat"] | recs["is_ipvs"]) != 0) & (
        (ser_ip != nat_ser_ip).any(axis=1)
        | (recs["orig_ser"]["port"] != recs["nat_ser"]["port"]))
    recs = recs[translated]
    if not len(recs):
        return
    out = np.zeros(len(recs), wire.TCP_CONN_DT)
    for src, dst in (("orig_cli", "cli"), ("orig_ser", "ser"),
                     ("nat_cli", "nat_cli"), ("nat_ser", "nat_ser")):
        out[dst]["ip"] = _ip16_col(recs[src])
        out[dst]["port"] = recs[src]["port"]
    session._push(session.nat_conns, out)


# frameless stateful subtypes: consume into the session, emit nothing
_SESSION_DECODERS = {
    REF_NOTIFY_LISTEN_TASKMAP: decode_listen_taskmap,
    REF_NOTIFY_NOTIFICATION_MSG: decode_notification_msg,
    REF_NOTIFY_LISTENER_DOMAIN: decode_listener_domain,
    REF_NOTIFY_NAT_TCP: decode_nat_tcp,
    REF_NOTIFY_HOST_CPU_MEM_CHANGE: decode_cpu_mem_change,
    REF_NOTIFY_TASK_AGGR: decode_task_aggr,
    REF_NOTIFY_PARTHA_STATUS: decode_partha_status,
}


def decode_aggr_task(payload: bytes, nevents: int, host_id: int,
                     session: "RefSession | None" = None
                     ) -> tuple[np.ndarray, list]:
    fsz = REF_AGGR_TASK_DT.itemsize
    _check_nevents(nevents, payload, fsz, wire.MAX_TASKS_PER_BATCH,
                   "aggr_task")
    out = np.zeros(nevents, wire.AGGR_TASK_DT)
    names: list = []
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"aggr_task record {i} truncated")
        rec = np.frombuffer(payload, REF_AGGR_TASK_DT, count=1,
                            offset=off)[0]
        ilen = int(rec["issue_string_len"])
        end = off + fsz + ilen + int(rec["padding_len"])
        if end > len(payload):
            raise RefFrameError(f"aggr_task record {i} overflows frame")
        r = out[i]
        for f in ("aggr_task_id", "tcp_kbytes", "tcp_conns",
                  "total_cpu_pct", "rss_mb", "cpu_delay_msec",
                  "vm_delay_msec", "blkio_delay_msec", "ntasks_total",
                  "ntasks_issue", "curr_state", "curr_issue"):
            r[f] = rec[f]
        comm = rec["onecomm"].tobytes().split(b"\x00", 1)[0].decode(
            "utf-8", "replace")
        if comm:
            nid = InternTable.intern(comm, wire.NAME_KIND_COMM)
            r["comm_id"] = nid
            names.append((wire.NAME_KIND_COMM, nid, comm))
        # task→listener linkage from the session's LISTEN_TASKMAP map
        # (sessionless callers: 0 = unlinked)
        if session is not None:
            r["related_listen_id"] = session.rel_of_task.get(
                int(rec["aggr_task_id"]), 0)
        r["host_id"] = host_id
        off = end
    return out, names


def decode_new_listener(payload: bytes, nevents: int, host_id: int
                        ) -> tuple[np.ndarray, list]:
    """NEW_LISTENER walk → GYT LISTENER_INFO records (the svcinfo
    registry feed) + intern entries for comm/cmdline strings."""
    fsz = REF_NEW_LISTENER_DT.itemsize
    _check_nevents(nevents, payload, fsz, 2048, "new_listener")
    out = np.zeros(nevents, wire.LISTENER_INFO_DT)
    names: list = []
    off = 0
    for i in range(nevents):
        if off + fsz > len(payload):
            raise RefFrameError(f"new_listener record {i} truncated")
        rec = np.frombuffer(payload, REF_NEW_LISTENER_DT, count=1,
                            offset=off)[0]
        cmdlen = int(rec["cmdline_len"])
        end = off + fsz + cmdlen + int(rec["padding_len"])
        if end > len(payload):
            raise RefFrameError(f"new_listener record {i} overflows")
        r = out[i]
        _copy_ip_port(r["addr"], rec["ns_ip_port"])
        for f in ("glob_id", "related_listen_id", "is_any_ip"):
            r[f] = rec[f]
        r["tusec_start"] = rec["tstart_usec"]
        r["pid"] = rec["start_pid"]
        comm = rec["comm"].tobytes().split(b"\x00", 1)[0].decode(
            "utf-8", "replace")
        if comm:
            nid = InternTable.intern(comm, wire.NAME_KIND_COMM)
            r["comm_id"] = nid
            names.append((wire.NAME_KIND_COMM, nid, comm))
        if cmdlen:
            # NAME_KIND_COMM: the kind svcinfo resolves cmdline_id
            # through (utils/svcreg.py:93), same as the GYT agent
            cmdline = payload[off + fsz: off + fsz + cmdlen].split(
                b"\x00", 1)[0].decode("utf-8", "replace")
            nid = InternTable.intern(cmdline, wire.NAME_KIND_COMM)
            r["cmdline_id"] = nid
            names.append((wire.NAME_KIND_COMM, nid, cmdline))
        r["host_id"] = host_id
        off = end
    return out, names


def decode_active_conn(payload: bytes, nevents: int, host_id: int
                       ) -> tuple[np.ndarray, list]:
    """ACTIVE_CONN_STATS → synthetic GYT TCP_CONN records.

    Each reference record aggregates one (listener, client
    process-group) pair's live traffic; the engine's conn fold keys
    flows by 5-tuple, so the synthetic record carries a flow identity
    derived from (listener_glob_id, cli_aggr_task_id, remote machine)
    — unique and STABLE per pair, so repeated stats for the same pair
    hit the same flow slot (bytes accumulate; the distinct-client HLL
    counts each pair once, matching the reference's per-pair
    aggregation in its activeconn tables)."""
    fsz = REF_ACTIVE_CONN_DT.itemsize
    _check_nevents(nevents, payload, fsz, 2048, "active_conn_stats")
    recs = np.frombuffer(payload, REF_ACTIVE_CONN_DT, count=nevents)
    out = np.zeros(nevents, wire.TCP_CONN_DT)
    names: list = []
    out["ser_glob_id"] = recs["listener_glob_id"]
    out["cli_task_aggr_id"] = recs["cli_aggr_task_id"]
    out["bytes_sent"] = recs["bytes_sent"]
    out["bytes_rcvd"] = recs["bytes_received"]
    out["peer_machine_id_hi"] = recs["machid_hi"]
    out["peer_machine_id_lo"] = recs["machid_lo"]
    out["ser_madhava_id"] = recs["remote_madhava_id"]
    # synthetic flow identity: mix the pair ids into the client
    # address bytes + port so decode.conn_batch's flow key is unique
    # per (svc, cli-group, remote machine) and repeatable
    cli_aggr = np.ascontiguousarray(recs["cli_aggr_task_id"])
    mix = np.ascontiguousarray(
        recs["listener_glob_id"]
        ^ np.uint64(0x9E3779B97F4A7C15) * cli_aggr
        ^ recs["machid_lo"])
    ip = out["cli"]["ip"]
    ip[:, 0:8] = mix.view(np.uint8).reshape(-1, 8)
    ip[:, 8:16] = cli_aggr.view(np.uint8).reshape(-1, 8)
    out["cli"]["port"] = (mix & np.uint64(0xFFFF)).astype(np.uint16)
    out["ser"]["port"] = 1
    # server-side observation unless the listener itself is remote
    is_remote_listen = (recs["connflags"] & 2) != 0
    out["flags"] = np.where(is_remote_listen, 0, 2)   # is_accept bit
    out["host_id"] = host_id
    for i in range(nevents):
        for f in ("ser_comm", "cli_comm"):
            s = recs[i][f].tobytes().split(b"\x00", 1)[0].decode(
                "utf-8", "replace")
            if s:
                nid = InternTable.intern(s, wire.NAME_KIND_COMM)
                out[i]["ser_comm_id" if f == "ser_comm"
                       else "cli_comm_id"] = nid
                names.append((wire.NAME_KIND_COMM, nid, s))
    return out, names


def decode_task_top_procs(payload: bytes, nevents: int, host_id: int
                          ) -> tuple[np.ndarray, list]:
    """TASK_TOP_PROCS → GYT AGGR_TASK_STATE records.

    The reference sends top-N CPU / process-group / RSS / fork-rate
    slices per host; GYT's topcpu/toppgcpu/toprss/topfork subsystems
    are sort presets over the task slab, so the slices fold as task
    records (cpu%/rss from the top lists, fork rate from the fork
    list) and the views come out the same way the host-collector path
    produces them (``net/taskproc.py``)."""
    hsz = REF_TOP_HDR_DT.itemsize
    rows: list = []
    names: list = []
    off = 0
    for i in range(nevents):
        if off + hsz > len(payload):
            raise RefFrameError(f"task_top_procs {i} truncated")
        hdr = np.frombuffer(payload, REF_TOP_HDR_DT, count=1,
                            offset=off)[0]
        np_, npg, nrss, nfork = (int(hdr["nprocs"]),
                                 int(hdr["npg_procs"]),
                                 int(hdr["nrss_procs"]),
                                 int(hdr["nfork_procs"]))
        need = (hsz + (np_ + nrss) * REF_TOP_TASK_DT.itemsize
                + npg * REF_TOP_PG_DT.itemsize
                + nfork * REF_TOP_FORK_DT.itemsize)
        # caps are the reference's TASK_MAX_*_N (gy_comm_proto.h:1418);
        # ext_data_len_ is defined as exactly the four arrays' bytes
        # (TASK_TOP_PROCS::validate, gy_comm_proto.cc:677) — a nonzero
        # mismatch means a layout drift we must not guess through
        ext = int(hdr["ext_data_len"])
        if np_ > 15 or npg > 10 or nrss > 8 or nfork > 5 \
                or off + need > len(payload) \
                or (ext and ext != need - hsz):
            raise RefFrameError(f"task_top_procs {i} overflows")
        o = off + hsz
        top = np.frombuffer(payload, REF_TOP_TASK_DT, count=np_,
                            offset=o)
        o += np_ * REF_TOP_TASK_DT.itemsize
        pg = np.frombuffer(payload, REF_TOP_PG_DT, count=npg, offset=o)
        o += npg * REF_TOP_PG_DT.itemsize
        rss = np.frombuffer(payload, REF_TOP_TASK_DT, count=nrss,
                            offset=o)
        o += nrss * REF_TOP_TASK_DT.itemsize
        fork = np.frombuffer(payload, REF_TOP_FORK_DT, count=nfork,
                             offset=o)
        off = off + need
        # group-id keyed merge: one task record per distinct aggr id
        acc: dict = {}

        def _merge(aid, comm, cpupct=0.0, rss_mb=0, ntasks=1,
                   forks=0.0):
            a = acc.setdefault(int(aid), dict(
                comm=comm, cpupct=0.0, rss_mb=0, ntasks=0, forks=0.0))
            a["cpupct"] = max(a["cpupct"], float(cpupct))
            a["rss_mb"] = max(a["rss_mb"], int(rss_mb))
            a["ntasks"] = max(a["ntasks"], int(ntasks))
            a["forks"] = max(a["forks"], float(forks))
        for t in top:
            _merge(t["aggr_task_id"], t["comm"], t["cpupct"],
                   t["rss_mb"])
        for t in pg:
            _merge(t["aggr_task_id"], t["pg_comm"], t["tot_cpupct"],
                   t["tot_rss_mb"], t["ntasks"])
        for t in rss:
            _merge(t["aggr_task_id"], t["comm"], t["cpupct"],
                   t["rss_mb"])
        for t in fork:
            _merge(t["aggr_task_id"], t["comm"],
                   forks=t["nfork_per_sec"])
        for aid, a in acc.items():
            r = np.zeros(1, wire.AGGR_TASK_DT)[0]
            r["aggr_task_id"] = aid
            comm = a["comm"].tobytes().split(b"\x00", 1)[0].decode(
                "utf-8", "replace") if a["comm"] is not None else ""
            if comm:
                nid = InternTable.intern(comm, wire.NAME_KIND_COMM)
                r["comm_id"] = nid
                names.append((wire.NAME_KIND_COMM, nid, comm))
            r["total_cpu_pct"] = a["cpupct"]
            r["rss_mb"] = a["rss_mb"]
            r["ntasks_total"] = max(a["ntasks"], 1)
            r["forks_sec"] = a["forks"]
            r["host_id"] = host_id
            rows.append(r)
    out = np.array(rows, wire.AGGR_TASK_DT) if rows \
        else np.empty(0, wire.AGGR_TASK_DT)
    return out, names


# subtype → (decoder, gyt_subtype, wants_session): session-aware
# decoders take the per-conn RefSession as a keyword (table-encoded so
# the dispatch loop stays generic as stateful subtypes accumulate)
_DECODER_OF = {
    REF_NOTIFY_TCP_CONN: (decode_tcp_conn, wire.NOTIFY_TCP_CONN,
                          False),
    REF_NOTIFY_LISTENER_STATE: (decode_listener_state,
                                wire.NOTIFY_LISTENER_STATE, False),
    REF_NOTIFY_AGGR_TASK_STATE: (decode_aggr_task,
                                 wire.NOTIFY_AGGR_TASK_STATE, True),
    REF_NOTIFY_NEW_LISTENER: (decode_new_listener,
                              wire.NOTIFY_LISTENER_INFO, False),
    REF_NOTIFY_ACTIVE_CONN_STATS: (decode_active_conn,
                                   wire.NOTIFY_TCP_CONN, False),
    REF_NOTIFY_TASK_TOP_PROCS: (decode_task_top_procs,
                                wire.NOTIFY_AGGR_TASK_STATE, False),
    REF_NOTIFY_CPU_MEM_STATE: (decode_cpu_mem,
                               wire.NOTIFY_CPU_MEM_STATE, True),
    REF_NOTIFY_HOST_STATE: (decode_host_state,
                            wire.NOTIFY_HOST_STATE, False),
    REF_NOTIFY_HOST_INFO: (decode_host_info,
                           wire.NOTIFY_HOST_INFO, True),
    REF_NOTIFY_REQ_TRACE_TRAN: (decode_req_trace_tran,
                                wire.NOTIFY_REQ_TRACE, False),
    REF_NOTIFY_PING_TASK_AGGR: (decode_ping_task_aggr,
                                wire.NOTIFY_TASK_PING, False),
}


# ------------------------------------------------ registration handshake
def _cstr(rec_field) -> str:
    return rec_field.tobytes().split(b"\x00", 1)[0].decode(
        "utf-8", "replace")


def parse_ps_register_req(body: bytes) -> dict:
    """PS_REGISTER_REQ_S payload → field dict (raises on short body)."""
    if len(body) < REF_PS_REGISTER_REQ_DT.itemsize:
        raise RefFrameError("short PS_REGISTER_REQ_S")
    r = np.frombuffer(body, REF_PS_REGISTER_REQ_DT, count=1)[0]
    return {
        "comm_version": int(r["comm_version"]),
        "partha_version": int(r["partha_version"]),
        "min_shyama_version": int(r["min_shyama_version"]),
        "machine_id_hi": int(r["machine_id_hi"]),
        "machine_id_lo": int(r["machine_id_lo"]),
        "hostname": _cstr(r["hostname"]),
        "cluster_name": _cstr(r["cluster_name"]),
        "region_name": _cstr(r["region_name"]),
        "zone_name": _cstr(r["zone_name"]),
        "kern_version_num": int(r["kern_version_num"]),
        "last_madhava_id": int(r["last_madhava_id"]),
    }


def parse_pm_connect_cmd(body: bytes) -> dict:
    """PM_CONNECT_CMD_S payload → field dict."""
    if len(body) < REF_PM_CONNECT_CMD_DT.itemsize:
        raise RefFrameError("short PM_CONNECT_CMD_S")
    r = np.frombuffer(body, REF_PM_CONNECT_CMD_DT, count=1)[0]
    return {
        "comm_version": int(r["comm_version"]),
        "partha_version": int(r["partha_version"]),
        "min_madhava_version": int(r["min_madhava_version"]),
        "machine_id_hi": int(r["machine_id_hi"]),
        "machine_id_lo": int(r["machine_id_lo"]),
        "partha_ident_key": int(r["partha_ident_key"]),
        "hostname": _cstr(r["hostname"]),
        "cluster_name": _cstr(r["cluster_name"]),
        "region_name": _cstr(r["region_name"]),
        "zone_name": _cstr(r["zone_name"]),
        "madhava_id": int(r["madhava_id"]),
        "cli_type": int(r["cli_type"]),
    }


def _ref_frame(data_type: int, payload: np.ndarray, magic: int) -> bytes:
    hdr = np.zeros(1, REF_HEADER_DT)
    hdr[0]["magic"] = magic
    hdr[0]["total_sz"] = _HSZ + payload.nbytes
    hdr[0]["data_type"] = data_type
    return hdr.tobytes() + payload.tobytes()


def encode_ps_register_resp(error_code: int, error_string: str,
                            madhava_hostname: str, madhava_port: int,
                            partha_ident_key: int, madhava_id: int,
                            curr_sec: int) -> bytes:
    """Byte-exact PS_REGISTER_RESP_S frame (the shyama reply that
    points the partha at its madhava — here: ourselves)."""
    r = np.zeros(1, REF_PS_REGISTER_RESP_DT)
    v = r[0]
    v["error_code"] = error_code
    v["error_string"] = error_string.encode()[:255]
    v["comm_version"] = REF_COMM_VERSION
    v["shyama_version"] = REF_MADHAVA_VERSION
    v["shyama_id"] = madhava_id ^ 0x5359414D41       # distinct role id
    v["partha_ident_key"] = partha_ident_key
    v["madhava_expiry_sec"] = curr_sec + 900
    v["madhava_id"] = madhava_id
    v["madhava_port"] = madhava_port
    v["madhava_hostname"] = madhava_hostname.encode()[:255]
    v["madhava_name"] = b"gyt-tpu"
    return _ref_frame(REF_COMM_PS_REGISTER_RESP, r, REF_MAGIC_PS)


def encode_pm_connect_resp(error_code: int, error_string: str,
                           madhava_id: int, curr_sec: int) -> bytes:
    """Byte-exact PM_CONNECT_RESP_S frame."""
    r = np.zeros(1, REF_PM_CONNECT_RESP_DT)
    v = r[0]
    v["error_code"] = error_code
    v["error_string"] = error_string.encode()[:255]
    v["madhava_id"] = madhava_id
    v["comm_version"] = REF_COMM_VERSION
    v["madhava_version"] = REF_MADHAVA_VERSION
    v["madhava_name"] = b"gyt-tpu"
    v["curr_sec"] = curr_sec
    v["clock_sec"] = curr_sec
    return _ref_frame(REF_COMM_PM_CONNECT_RESP, r, REF_MAGIC_PM)


def encode_ps_register_req(machine_id_hi: int, machine_id_lo: int,
                           hostname: str = "parthahost",
                           partha_version: int = 0x000501,
                           comm_version: int = REF_COMM_VERSION,
                           curr_sec: int = 0) -> bytes:
    """Synthesized stock-partha PS_REGISTER_REQ_S (fixture source —
    what partha/gy_paconnhdlr.cc:1730 sends)."""
    r = np.zeros(1, REF_PS_REGISTER_REQ_DT)
    v = r[0]
    v["comm_version"] = comm_version
    v["partha_version"] = partha_version
    v["min_shyama_version"] = 0x000500
    v["machine_id_hi"] = machine_id_hi
    v["machine_id_lo"] = machine_id_lo
    v["hostname"] = hostname.encode()[:255]
    v["cluster_name"] = b"cluster0"
    v["curr_sec"] = curr_sec
    return _ref_frame(REF_COMM_PS_REGISTER_REQ, r, REF_MAGIC_PS)


def encode_pm_connect_cmd(machine_id_hi: int, machine_id_lo: int,
                          partha_ident_key: int, madhava_id: int,
                          hostname: str = "parthahost",
                          partha_version: int = 0x000501,
                          comm_version: int = REF_COMM_VERSION,
                          min_madhava_version: int = 0x000500,
                          cli_type: int = REF_CLI_TYPE_REQ_ONLY,
                          curr_sec: int = 0, region: str = "",
                          zone: str = "") -> bytes:
    """Synthesized stock-partha PM_CONNECT_CMD_S."""
    r = np.zeros(1, REF_PM_CONNECT_CMD_DT)
    v = r[0]
    v["comm_version"] = comm_version
    v["partha_version"] = partha_version
    v["min_madhava_version"] = min_madhava_version
    v["machine_id_hi"] = machine_id_hi
    v["machine_id_lo"] = machine_id_lo
    v["partha_ident_key"] = partha_ident_key
    v["hostname"] = hostname.encode()[:255]
    v["cluster_name"] = b"cluster0"
    v["region_name"] = region.encode()[:63]
    v["zone_name"] = zone.encode()[:63]
    v["madhava_id"] = madhava_id
    v["cli_type"] = cli_type
    v["curr_sec"] = curr_sec
    return _ref_frame(REF_COMM_PM_CONNECT_CMD, r, REF_MAGIC_PM)


def parse_ps_register_resp(buf: bytes) -> dict:
    """Client-side decode of PS_REGISTER_RESP_S (fixture assertions)."""
    hdr = np.frombuffer(buf, REF_HEADER_DT, count=1)[0]
    r = np.frombuffer(buf, REF_PS_REGISTER_RESP_DT, count=1,
                      offset=_HSZ)[0]
    return {"data_type": int(hdr["data_type"]),
            "error_code": int(r["error_code"]),
            "error_string": _cstr(r["error_string"]),
            "partha_ident_key": int(r["partha_ident_key"]),
            "madhava_id": int(r["madhava_id"]),
            "madhava_port": int(r["madhava_port"]),
            "madhava_hostname": _cstr(r["madhava_hostname"])}


def parse_pm_connect_resp(buf: bytes) -> dict:
    hdr = np.frombuffer(buf, REF_HEADER_DT, count=1)[0]
    r = np.frombuffer(buf, REF_PM_CONNECT_RESP_DT, count=1,
                      offset=_HSZ)[0]
    return {"data_type": int(hdr["data_type"]),
            "error_code": int(r["error_code"]),
            "error_string": _cstr(r["error_string"]),
            "madhava_id": int(r["madhava_id"]),
            "madhava_version": int(r["madhava_version"])}


def adapt(buf: bytes, host_id: int,
          session: "RefSession | None" = None) -> tuple[bytes, int]:
    """Reference byte stream → GYT wire frames, ready for
    ``Runtime.feed``.

    Walks COMM_HEADER frames (trailing partial frame left for the
    caller, epoll-resume semantics like ``wire.decode_frames``);
    adapts known partha→madhava event subtypes, emits NAME_INTERN
    frames for every trailing string, and skips unknown subtypes
    frame-whole. ``session`` carries per-connection adapter state
    (the LISTEN_TASKMAP task→listener linkage). Returns
    ``(gyt_bytes, consumed)``.
    """
    out: list[bytes] = []
    off = 0
    n = len(buf)
    while off + _HSZ <= n:
        hdr = np.frombuffer(buf, REF_HEADER_DT, count=1, offset=off)[0]
        if int(hdr["magic"]) not in REF_MAGICS:
            raise RefFrameError(f"bad reference magic "
                                f"0x{int(hdr['magic']):08x}")
        total = int(hdr["total_sz"])
        if total < _HSZ or total >= wire.MAX_COMM_DATA_SZ:
            raise RefFrameError(f"bad total_sz {total}")
        if off + total > n:
            break                         # partial frame: resume later
        pad = int(hdr["padding_sz"])
        if pad > total - _HSZ:            # unvalidated pad would slice
            raise RefFrameError(          # outside the declared frame
                f"bad padding_sz {pad} for total_sz {total}")
        if int(hdr["data_type"]) == REF_COMM_EVENT_NOTIFY \
                and total - pad >= _HSZ + _ESZ:
            ev = np.frombuffer(buf, REF_EVENT_NOTIFY_DT, count=1,
                               offset=off + _HSZ)[0]
            subtype = int(ev["subtype"])
            # payload slices LAZILY: unknown subtypes skip frame-whole
            # without paying a bytes copy on the ingest hot path
            sdec = _SESSION_DECODERS.get(subtype)
            if sdec is not None:
                # stateful, frameless: consumed into the session
                if session is not None:
                    sdec(buf[off + _HSZ + _ESZ: off + total - pad],
                         int(ev["nevents"]), session)
                    session.n_events[subtype] += int(ev["nevents"])
                off += total
                continue
            dec = _DECODER_OF.get(subtype)
            if dec is not None:
                fn, gyt_subtype, wants_session = dec
                payload = buf[off + _HSZ + _ESZ: off + total - pad]
                if wants_session:
                    recs, names = fn(payload, int(ev["nevents"]),
                                     host_id, session=session)
                else:
                    recs, names = fn(payload, int(ev["nevents"]),
                                     host_id)
                if names:
                    out.append(wire.encode_frames_chunked(
                        wire.NOTIFY_NAME_INTERN,
                        InternTable.records(names)))
                out.append(wire.encode_frames_chunked(gyt_subtype,
                                                      recs))
                if session is not None:
                    session.n_events[subtype] += len(recs)
            elif session is not None:
                session.n_skipped += 1
        elif session is not None:
            # non-NOTIFY data types and truncated NOTIFY bodies skip
            # frame-whole too — count them so data loss is visible
            session.n_skipped += 1
        off += total
    return b"".join(out), off
