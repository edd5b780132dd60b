"""Per-subsystem field maps: JSON field ↔ column ↔ type ↔ enum codec.

The tensor-era analogue of ``common/gy_json_field_maps.h`` (~40 subsystems
of ``JSON_DB_MAPPING`` tables, e.g. hoststate :785, svcstate :1102): every
queryable subsystem declares its fields once; the criteria engine and the
JSON writers are generic over these tables. JSON field names match the
reference's query API so existing Gyeeta queries port unchanged.

A copy of ``gyeeta_tpu/query/fieldmaps.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from gyeeta_tpu_torch.semantic.states import CPU_ISSUE_NAMES, ISSUE_NAMES, \
    MEM_ISSUE_NAMES, STATE_NAMES, TASK_ISSUE_NAMES

SUBSYS_SVCSTATE = "svcstate"
SUBSYS_HOSTSTATE = "hoststate"
SUBSYS_CLUSTERSTATE = "clusterstate"
SUBSYS_FLOWSTATE = "flowstate"      # heavy-hitter flows (TPU-first)
SUBSYS_SVCINFO = "svcinfo"
SUBSYS_TASKSTATE = "taskstate"      # ref aggrtaskstate
# top-N process-group views (ref TASK_TOP_PROCS, gy_comm_proto.h:1415:
# top CPU / PG CPU / RSS / forks — here: preset-sorted taskstate views)
SUBSYS_TOPCPU = "topcpu"
SUBSYS_TOPPGCPU = "toppgcpu"        # ref toppgcpu (groups ARE our unit;
#                                     alias preset of topcpu)
SUBSYS_PROCINFO = "procinfo"        # ref procinfo (static group info)
SUBSYS_TOPRSS = "toprss"
SUBSYS_TOPDELAY = "topdelay"
SUBSYS_TOPFORK = "topfork"          # ref TOPFORK (top fork-rate groups)
SUBSYS_SVCDEP = "svcdependency"     # ref DEPENDS_LISTENER / svcprocmap
SUBSYS_SVCMESH = "svcmesh"          # ref svc mesh clusters (shyama)
SUBSYS_CPUMEM = "cpumem"            # ref cpumem (2s host cpu/mem state)
SUBSYS_TRACEREQ = "tracereq"        # ref tracereq (request tracing)
SUBSYS_ACTIVECONN = "activeconn"    # ref activeconn (per-svc client view)
SUBSYS_HOSTINFO = "hostinfo"        # ref hostinfo (static host inventory)
SUBSYS_SVCSUMM = "svcsumm"          # ref svcsumm (per-host summary)
SUBSYS_EXTSVCSTATE = "extsvcstate"  # ref extsvcstate (state ⋈ info)
SUBSYS_CLIENTCONN = "clientconn"    # ref clientconn (outbound view)
SUBSYS_SVCPROCMAP = "svcprocmap"    # ref svcprocmap (listener↔procs)
SUBSYS_NOTIFYMSG = "notifymsg"      # ref notifymsg
SUBSYS_HOSTLIST = "hostlist"        # ref parthalist (agents + liveness)
SUBSYS_SERVERSTATUS = "serverstatus"  # ref madhavastatus/shyamastatus
SUBSYS_TRACEDEF = "tracedef"        # ref tracedef (capture control)
SUBSYS_TRACESTATUS = "tracestatus"  # ref tracestatus
SUBSYS_TRACEUNIQ = "traceuniq"      # ref traceuniq (APIs per svc)
SUBSYS_TRACECONN = "traceconn"      # ref traceconn (traced conns)
SUBSYS_TAGS = "tags"                # ref tags (user process-group tags)
SUBSYS_MOUNTSTATE = "mountstate"    # ref MOUNT_HDLR (mount/freespace)
SUBSYS_NETIF = "netif"              # ref NET_IF_HDLR (interfaces)
SUBSYS_EXTACTIVECONN = "extactiveconn"  # ref extactiveconn (⋈ svcinfo)
SUBSYS_EXTCLIENTCONN = "extclientconn"  # ref extclientconn (⋈ svcinfo)
SUBSYS_EXTTRACEREQ = "exttracereq"  # ref exttracereq (⋈ svcinfo)
SUBSYS_SHARDLIST = "shardlist"      # mesh-native: per-shard stats (the
#                                     madhavalist analogue — one row per
#                                     shard instead of per madhava)
SUBSYS_CGROUPSTATE = "cgroupstate"  # ref cgroupstate
SUBSYS_SVCIPCLUST = "svcipclust"    # ref NAT-IP / VIP clusters
SUBSYS_TOPK = "topk"                # heavy hitters (TPU-first): exact
#                                     top-K lanes ∪ keys recovered from
#                                     the invertible sketch + dense
#                                     svc/api rankings, every row bound-
#                                     annotated (sketch/invertible.py)
SUBSYS_ALERTS = "alerts"            # ref alerts (fired alert log)
SUBSYS_ALERTDEF = "alertdef"        # ref alertdef
SUBSYS_SILENCES = "silences"        # ref silences
SUBSYS_INHIBITS = "inhibits"        # ref inhibits
SUBSYS_ACTIONS = "actions"          # ref actions (alert routing targets)


class FieldDef(NamedTuple):
    json: str                       # JSON/query field name (reference name)
    col: str                        # column key in the readback dict
    kind: str                       # "num" | "str" | "bool" | "enum"
    to_json: Optional[Callable] = None     # value → JSON value
    from_json: Optional[Callable] = None   # query literal → comparable value
    desc: str = ""


def _enum_codec(names):
    lower = [n.lower() for n in names]

    def enc(v):
        i = int(v)
        return names[i] if 0 <= i < len(names) else str(i)

    def dec(s):
        if isinstance(s, (int, float)):
            return float(s)
        try:
            return float(lower.index(str(s).lower()))
        except ValueError:
            raise ValueError(f"unknown enum literal {s!r}; one of {names}")

    return enc, dec


_state_enc, _state_dec = _enum_codec(STATE_NAMES)
_issue_enc, _issue_dec = _enum_codec(ISSUE_NAMES)
_tissue_enc, _tissue_dec = _enum_codec(TASK_ISSUE_NAMES)
_cissue_enc, _cissue_dec = _enum_codec(CPU_ISSUE_NAMES)
_missue_enc, _missue_dec = _enum_codec(MEM_ISSUE_NAMES)


def num(json, col, desc=""):
    return FieldDef(json, col, "num", desc=desc)


def boolean(json, col, desc=""):
    return FieldDef(json, col, "bool", desc=desc)


def enum(json, col, enc, dec, desc=""):
    return FieldDef(json, col, "enum", to_json=enc, from_json=dec, desc=desc)


def string(json, col, desc=""):
    return FieldDef(json, col, "str", desc=desc)


# --------------------------------------------------------------- svcstate
# ref json_db_svcstate_arr (gy_json_field_maps.h:1102); column keys are the
# keys of query.api.svc_columns()
SVCSTATE_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name (interned)"),
    num("qps5s", "qps5s", "Current queries/sec"),
    num("nqry5s", "nqry5s", "Queries in last 5s window"),
    num("resp5s", "resp5s", "Mean response last 5s (msec)"),
    num("p95resp5s", "p95resp5s", "p95 response last 5s (msec)"),
    num("p95resp5m", "p95resp5m", "p95 response last 5min (msec)"),
    num("p99resp5s", "p99resp5s", "p99 response last 5s (msec)"),
    num("nconns", "nconns", "Total connections"),
    num("nactive", "nactive", "Active connections"),
    num("nprocs", "nprocs", "Listener processes"),
    num("kbin15s", "kbin15s", "Inbound KB"),
    num("kbout15s", "kbout15s", "Outbound KB"),
    num("sererr", "sererr", "Server errors"),
    num("clierr", "clierr", "Client errors"),
    num("delayus", "delayus", "Process delays usec"),
    num("cpudelus", "cpudelus", "CPU delays usec"),
    num("iodelus", "iodelus", "Block IO delays usec"),
    num("usercpu", "usercpu", "User CPU %"),
    num("syscpu", "syscpu", "System CPU %"),
    num("rssmb", "rssmb", "Resident memory MB"),
    num("nissue", "nissue", "Processes with issues"),
    enum("state", "state", _state_enc, _state_dec,
         "Service state per analysis"),
    enum("issue", "issue", _issue_enc, _issue_dec, "Issue source"),
    num("hostid", "hostid", "Owning host id"),
    num("nclients", "nclients", "Distinct client endpoints (HLL)"),
    num("p50resp5d", "p50resp5d", "p50 response 5-day window (msec)"),
    num("p95resp5d", "p95resp5d", "p95 response 5-day window (msec)"),
)

# -------------------------------------------------------------- hoststate
# ref json_db_hoststate_arr (gy_json_field_maps.h:785)
HOSTSTATE_FIELDS = (
    num("hostid", "hostid", "Host id"),
    string("hostname", "hostname", "Hostname (interned)"),
    num("nprocissue", "nprocissue", "Processes with issues"),
    num("nprocsevere", "nprocsevere", "Processes with severe issues"),
    num("nproc", "nproc", "Total processes"),
    num("nlistissue", "nlistissue", "Listeners with issues"),
    num("nlistsevere", "nlistsevere", "Listeners with severe issues"),
    num("nlisten", "nlisten", "Total listeners"),
    enum("state", "state", _state_enc, _state_dec, "Host state"),
    boolean("cpuissue", "cpuissue", "Host CPU issue"),
    boolean("memissue", "memissue", "Host memory issue"),
    boolean("severecpu", "severecpu", "Severe CPU issue"),
    boolean("severemem", "severemem", "Severe memory issue"),
)

# ----------------------------------------------------------- clusterstate
# ref MS_CLUSTER_STATE (gy_comm_proto.h:3181) / shyama aggregate
CLUSTERSTATE_FIELDS = (
    num("nhosts", "nhosts", "Hosts reporting"),
    num("nidle", "nidle", "Hosts Idle"),
    num("ngood", "ngood", "Hosts Good"),
    num("nok", "nok", "Hosts OK"),
    num("nbad", "nbad", "Hosts Bad"),
    num("nsevere", "nsevere", "Hosts Severe"),
    num("ndown", "ndown", "Hosts Down"),
    num("issuefrac", "issue_frac", "Fraction of hosts Bad/Severe"),
)

# -------------------------------------------------------------- taskstate
# ref json_db_aggrtaskstate_arr / MAGGR_TASK fields (gy_comm_proto.h:2114,
# server/gy_msocket.h MAGGR_TASK); comm resolved via the intern table
TASKSTATE_FIELDS = (
    string("taskid", "taskid", "Process-group (aggregate task) id (hex)"),
    string("comm", "comm", "Process command name"),
    string("relsvcid", "relsvcid", "Related listener (service) id (hex)"),
    num("tcpkb", "tcpkb", "TCP KB transferred in last 5s"),
    num("tcpconns", "tcpconns", "TCP connections"),
    num("cpu", "cpu", "Total CPU %% (all group processes)"),
    num("cpup95", "cpup95", "Learned p95 CPU %% baseline"),
    num("rssmb", "rssmb", "Resident memory MB"),
    num("cpudelms", "cpudelms", "CPU delay msec (taskstats)"),
    num("vmdelms", "vmdelms", "VM (swap/reclaim) delay msec"),
    num("iodelms", "iodelms", "Block IO delay msec"),
    num("ntasks", "ntasks", "Processes in the group"),
    num("nissue", "nissue", "Processes with issues"),
    num("forks", "forks", "Process forks/sec in the group"),
    enum("state", "state", _state_enc, _state_dec, "Group state"),
    enum("issue", "issue", _tissue_enc, _tissue_dec, "Issue source"),
    num("hostid", "hostid", "Owning host id"),
)

# --------------------------------------------------------------- procinfo
# ref SUBSYS_PROCINFO (aggrtaskinfotbl): the static face of a process
# group — identity, placement, service linkage
PROCINFO_FIELDS = (
    string("taskid", "taskid", "Process-group id (hex)"),
    string("comm", "comm", "Process command name"),
    string("relsvcid", "relsvcid", "Related listener (service) id (hex)"),
    string("svcname", "svcname", "Linked service name ('' if none)"),
    num("ntasks", "ntasks", "Processes in the group"),
    num("hostid", "hostid", "Owning host id"),
    string("tag", "tag", "User tag (CRUD objtype 'tag'; ref "
                         "MAGGR_TASK tagbuf_, gy_msocket.h:960)"),
)

# ------------------------------------------------------------------- tags
# ref SUBSYS_TAGS (gy_json_field_maps.h:55 — a bare enum there; the
# working feature is the per-group tag buffer): the tag registry as its
# own listing
TAGS_FIELDS = (
    string("taskid", "taskid", "Tagged process-group id (hex)"),
    string("tag", "tag", "User tag text"),
)

# ------------------------------------------------------------- mountstate
# ref MOUNT_HDLR inventory (gy_mount_disk.h:233): per-mount filesystem
# + freespace, pseudo-fs excluded agent-side
MOUNTSTATE_FIELDS = (
    num("hostid", "hostid", "Reporting host id"),
    string("mnt", "mnt", "Mount point path"),
    string("fstype", "fstype", "Filesystem type"),
    num("sizemb", "sizemb", "Filesystem size MB"),
    num("freemb", "freemb", "Free space MB (unprivileged avail)"),
    num("usedpct", "usedpct", "Space used %%"),
    num("inodepct", "inodepct", "Inodes used %%"),
    boolean("netfs", "netfs", "Network filesystem (nfs/cifs/…)"),
)

# ------------------------------------------------------------------ netif
# ref NET_IF_HDLR (gy_netif.h:708): interface inventory + rates
NETIF_FIELDS = (
    num("hostid", "hostid", "Reporting host id"),
    string("name", "name", "Interface name"),
    num("speedmbps", "speedmbps", "Link speed Mbps (-1 unknown)"),
    num("rxmbsec", "rxmbsec", "Receive MB/s"),
    num("txmbsec", "txmbsec", "Transmit MB/s"),
    num("rxerrsec", "rxerrsec", "Receive errors/s"),
    num("txerrsec", "txerrsec", "Transmit errors/s"),
    boolean("up", "up", "Operationally up"),
)

# ---------------------------------------------------------- svcdependency
# ref DEPENDS_LISTENER (common/gy_socket_stat.h:721) +
# LISTENER_DEPENDENCY_NOTIFY (gy_comm_proto.h:2333): one row per
# caller→service edge of the dependency graph
SVCDEP_FIELDS = (
    string("cliid", "cliid", "Caller entity id (hex): listener or "
           "process-group"),
    string("cliname", "cliname", "Caller name (interned)"),
    boolean("clisvc", "clisvc", "Caller is itself a service (mesh edge)"),
    string("serid", "serid", "Callee service glob id (hex)"),
    string("sername", "sername", "Callee service name"),
    num("nconn", "nconn", "Flows folded into this edge"),
    num("bytes", "bytes", "Total bytes over this edge"),
)

# -------------------------------------------------------------- svcmesh
# ref coalesce_svc_mesh_clusters (server/gy_shconnhdlr.cc:5198): one row
# per service in the svc→svc mesh, labelled by coalesced cluster
SVCMESH_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name (interned)"),
    num("clusterid", "clusterid", "Cluster label (min reachable node row)"),
    num("clustersize", "clustersize", "Services in this cluster"),
)

# ---------------------------------------------------------------- cpumem
# ref json_db_cpumem_arr (the 2s CPU_MEM_STATE path, gy_comm_proto.h:2024)
CPUMEM_FIELDS = (
    num("hostid", "hostid", "Host id"),
    string("hostname", "hostname", "Hostname (interned)"),
    num("cpu", "cpu", "Total CPU %"),
    num("usercpu", "usercpu", "User CPU %"),
    num("syscpu", "syscpu", "System CPU %"),
    num("iowait", "iowait", "IO-wait %"),
    num("corecpu", "corecpu", "Hottest core CPU %"),
    num("cs", "cs", "Context switches/sec"),
    num("forks", "forks", "Forks/sec"),
    num("runq", "runq", "Runnable processes"),
    num("rsspct", "rsspct", "Resident memory %"),
    num("commitpct", "commitpct", "Committed memory %"),
    num("swapfreepct", "swapfreepct", "Swap free %"),
    num("pginout", "pginout", "Pages in+out/sec"),
    num("swapinout", "swapinout", "Swap pages in+out/sec"),
    num("allocstall", "allocstall", "Direct-reclaim stalls/sec"),
    num("oom", "oom", "OOM kills in window"),
    enum("cpustate", "cpustate", _state_enc, _state_dec,
         "CPU state per 2s analysis"),
    enum("cpuissue", "cpuissue", _cissue_enc, _cissue_dec,
         "CPU issue source"),
    enum("memstate", "memstate", _state_enc, _state_dec,
         "Memory state per 2s analysis"),
    enum("memissue", "memissue", _missue_enc, _missue_dec,
         "Memory issue source"),
)

# --------------------------------------------------------------- tracereq
# ref json_db_tracereq_arr (request-trace aggregates): one row per
# (service, normalized API signature)
from gyeeta_tpu_torch.trace.proto import (  # noqa: E402
    PROTO_NAMES as _PROTO_NAMES)

_proto_enc, _proto_dec = _enum_codec(_PROTO_NAMES)

TRACEREQ_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name (interned)"),
    string("api", "api", "Normalized API signature (interned)"),
    enum("proto", "proto", _proto_enc, _proto_dec,
         "Application protocol"),
    num("nreq", "nreq", "Transactions folded"),
    num("nerr", "nerr", "Errored transactions"),
    num("bytesin", "bytesin", "Request bytes"),
    num("bytesout", "bytesout", "Response bytes"),
    num("p50resp", "p50resp", "p50 latency (msec)"),
    num("p95resp", "p95resp", "p95 latency (msec)"),
    num("p99resp", "p99resp", "p99 latency (msec)"),
    num("hostid", "hostid", "Last reporting host"),
)

# ---------------------------------------------------------------- svcinfo
# ref json_db_svcinfo_arr: static listener metadata (announce-rate,
# host-side registry utils/svcreg.py)
SVCINFO_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name (interned)"),
    string("ip", "ip", "Bind address"),
    num("port", "port", "Listen port"),
    num("tstart", "tstart", "Listener start time (epoch sec)"),
    string("comm", "comm", "Listener process comm"),
    string("cmdline", "cmdline", "Command line (interned)"),
    num("pid", "pid", "Listener pid"),
    boolean("anyip", "anyip", "Bound to ANY address"),
    boolean("ishttp", "ishttp", "Serves HTTP"),
    num("hostid", "hostid", "Owning host id"),
)

# -------------------------------------------------------------- activeconn
# ref json_db_activeconn_arr: the per-service client view of the
# dependency edges (who talks to this service, how much)
ACTIVECONN_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name (interned)"),
    num("nclients", "nclients", "Distinct caller entities"),
    num("nconn", "nconn", "Flows folded"),
    num("bytes", "bytes", "Total bytes"),
    num("nsvccli", "nsvccli", "Callers that are services"),
)

# -------------------------------------------------------------- flowstate
FLOWSTATE_FIELDS = (
    string("flowid", "flowid", "Flow key (hex)"),
    num("bytes", "bytes", "Bytes transferred (top-K estimate)"),
    num("evictedbytes", "evictedbytes", "Undercount bound (evicted mass)"),
)

# ------------------------------------------------------------------- topk
# Heavy-hitter rankings as one queryable union (ROADMAP "heavy-hitter
# detection as a first-class subsystem"): per-metric ranked rows from
# the exact top-K lanes, the invertible-sketch recovery, and the dense
# svc/api slabs. Flow-row ``value`` is an UPPER bound on the true
# total (never undercounts); its overcount is ≤ ``errbound`` — exact
# lanes tighten it to est − count (truth ∈ [count, est]), recovered
# rows carry the invertible-array term (2·N/width w.p. 1−2^−depth);
# dense rows are exact slab gauges (errbound 0).
TOPK_FIELDS = (
    string("metric", "metric",
           "Ranking: bytes | conns | errrate | p99resp"),
    num("rank", "rank", "1-based rank within the metric"),
    string("id", "id", "Entity id (hex): flow key / svcid / api key"),
    string("name", "name", "Entity name ('' for raw flows)"),
    num("value", "value", "Ranked stat value"),
    num("errbound", "errbound",
        "Error bound on value (evicted mass + invertible-array term)"),
    string("source", "source",
           "Row provenance: exact | recovered | dense"),
)

# ---------------------------------------------------------------- svcsumm
# ref SUBSYS_SVCSUMM (LISTEN_SUMM_STATS, server/gy_msocket.h:841):
# per-host service summary counts
SVCSUMM_FIELDS = (
    num("hostid", "hostid", "Host id"),
    string("hostname", "hostname", "Hostname (interned)"),
    num("nsvc", "nsvc", "Services on host"),
    num("nidle", "nidle", "Idle services"),
    num("ngood", "ngood", "Good services"),
    num("nok", "nok", "OK services"),
    num("nbad", "nbad", "Bad services"),
    num("nsevere", "nsevere", "Severe services"),
    num("ndown", "ndown", "Down services"),
    num("nissue", "nissue", "Services with issues (Bad+)"),
    num("totqps", "totqps", "Total QPS across services"),
    num("totactive", "totactive", "Total active connections"),
    num("totkbin", "totkbin", "Total inbound KB"),
    num("totkbout", "totkbout", "Total outbound KB"),
)

# ------------------------------------------------------------ extsvcstate
# ref EXTSVCSTATE: svcstate joined with svcinfo (gy_mnodehandle.cc:4657)
EXTSVCSTATE_FIELDS = SVCSTATE_FIELDS + (
    string("ip", "ip", "Bind address"),
    num("port", "port", "Listen port"),
    string("comm", "comm", "Listener process comm"),
    string("cmdline", "cmdline", "Command line (interned)"),
    num("pid", "pid", "Listener pid"),
    num("tstart", "tstart", "Listener start time (epoch sec)"),
)

# ------------------------------------------------------------- clientconn
# ref SUBSYS_CLIENTCONN (remoteconn): outbound view per caller entity
CLIENTCONN_FIELDS = (
    string("cliid", "cliid", "Caller entity id (hex)"),
    string("cliname", "cliname", "Caller name (interned)"),
    boolean("clisvc", "clisvc", "Caller is itself a service"),
    num("nservers", "nservers", "Distinct services called"),
    num("nconn", "nconn", "Flows folded"),
    num("bytes", "bytes", "Total bytes"),
)

# ------------------------------------------------------------- svcprocmap
# ref LISTEN_TASKMAP_NOTIFY (gy_comm_proto.h:2813): listener ↔
# process-group mapping
SVCPROCMAP_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name"),
    string("relsvcid", "relsvcid", "Related-listener group id (hex)"),
    string("taskid", "taskid", "Process-group id (hex)"),
    string("comm", "comm", "Process comm"),
    num("hostid", "hostid", "Host id"),
)

# -------------------------------------------------------------- notifymsg
# ref SUBSYS_NOTIFYMSG (notificationtbl, gy_mdb_schema.cc:101)
NOTIFYMSG_FIELDS = (
    num("time", "time", "Event time (epoch sec)"),
    string("type", "type", "info | warn | error"),
    string("source", "source", "agent | alert | server | config"),
    string("msg", "msg", "Message"),
)

# --------------------------------------------------------------- hostlist
# ref SUBSYS_PARTHALIST: registered agents + liveness
HOSTLIST_FIELDS = (
    num("hostid", "hostid", "Assigned host id"),
    string("hostname", "hostname", "Hostname (interned)"),
    boolean("up", "up", "Reported within the liveness window"),
    num("lastseen", "lastseen", "Ticks since last report (-1 never)"),
)

# ------------------------------------------------------------ serverstatus
# ref SUBSYS_MADHAVASTATUS/SHYAMASTATUS: one-row server self status
SERVERSTATUS_FIELDS = (
    num("uptime", "uptime", "Seconds since server start"),
    num("tick", "tick", "Current 5s window tick"),
    num("nhosts", "nhosts", "Hosts that have ever reported"),
    num("nsvc", "nsvc", "Live service rows"),
    num("connevents", "connevents", "Flow events ingested"),
    num("respevents", "respevents", "Response samples ingested"),
    num("queries", "queries", "Queries served"),
    num("alertsfired", "alertsfired", "Alerts notified"),
    num("wirever", "wirever", "Wire protocol version"),
    string("version", "version", "Server version"),
)

# ------------------------------------------------------------ trace defs
# ref tracedef / tracestatus subsystems (REQ_TRACE_DEF distribution,
# common/gy_trace_def.h; tracestatustbl)
TRACEDEF_FIELDS = (
    string("name", "name", "Trace definition name"),
    string("filter", "filter", "Service-selection criteria (svcinfo)"),
    num("tend", "tend", "Capture until (epoch sec; 0 = no expiry)"),
    boolean("active", "active", "Definition currently in effect"),
    num("nsvc", "nsvc", "Services currently capturing"),
)

TRACESTATUS_FIELDS = TRACEDEF_FIELDS

# ------------------------------------------------------------- traceuniq
# ref traceuniqtbl: distinct API signatures per service
TRACEUNIQ_FIELDS = (
    string("svcid", "svcid", "Service glob id (hex)"),
    string("svcname", "svcname", "Service name"),
    num("napis", "napis", "Distinct API signatures"),
    num("nreq", "nreq", "Transactions across APIs"),
    num("nerr", "nerr", "Errored transactions"),
)

# -------------------------------------------------------------- traceconn
# ref SUBSYS_TRACECONN (json_db_traceconn_arr, gy_json_field_maps.h:2670):
# the per-CONNECTION face of request tracing — who talks to the traced
# service over which connection
TRACECONN_FIELDS = (
    string("svcid", "svcid", "Traced service glob id (hex)"),
    string("name", "name", "Traced service name"),
    string("connid", "connid", "Traced connection id (hex)"),
    string("cprocid", "cprocid", "Client process-group id (hex)"),
    string("cname", "cname", "Client process comm"),
    boolean("csvc", "csvc", "Client is itself a service"),
    num("nreq", "nreq", "Requests seen on this connection"),
    num("hostid", "hostid", "Reporting host id"),
    num("idleticks", "idleticks", "Ticks since last request"),
)

# ------------------------------------------------------------- ext* joins
_EXTINFO_FIELDS = (
    string("ip", "ip", "Bind address"),
    num("port", "port", "Listen port"),
    string("comm", "comm", "Listener process comm"),
    string("cmdline", "cmdline", "Command line (interned)"),
    num("pid", "pid", "Listener pid"),
    num("tstart", "tstart", "Listener start time (epoch sec)"),
)

EXTACTIVECONN_FIELDS = ACTIVECONN_FIELDS + _EXTINFO_FIELDS
EXTCLIENTCONN_FIELDS = CLIENTCONN_FIELDS + _EXTINFO_FIELDS
EXTTRACEREQ_FIELDS = TRACEREQ_FIELDS + _EXTINFO_FIELDS

# ------------------------------------------------------------- svcipclust
# ref check_svc_nat_ip_clusters (server/gy_shconnhdlr.h:1301): services
# reached through one virtual IP = a load-balancer cluster
SVCIPCLUST_FIELDS = (
    string("vip", "vip", "Virtual (pre-NAT) ip:port dialed by clients"),
    string("dns", "dns", "Reverse-resolved VIP domain ('' pending/"
                         "unresolvable; ref gy_dns_mapping.h:46)"),
    string("svcid", "svcid", "Backend service glob id (hex)"),
    string("svcname", "svcname", "Backend service name"),
    num("nsvc", "nsvc", "Backends behind this VIP"),
)

# -------------------------------------------------------------- shardlist
SHARDLIST_FIELDS = (
    num("shard", "shard", "Mesh shard index"),
    num("nsvc", "nsvc", "Live service rows on this shard"),
    num("nhosts", "nhosts", "Hosts reporting to this shard"),
    num("nconn", "nconn", "Flow events folded on this shard"),
    num("nresp", "nresp", "Response samples folded on this shard"),
    num("ntaskrows", "ntaskrows", "Live process-group rows"),
    num("ndropped", "ndropped", "Table inserts dropped (probe exhaust)"),
)

# --------------------------------------------------------------- hostinfo
# ref json_db_hostinfo_arr (HOST_INFO_NOTIFY, gy_comm_proto.h:2843):
# static host inventory — hardware/OS/cloud metadata
HOSTINFO_FIELDS = (
    num("hostid", "hostid", "Host id"),
    string("host", "host", "Hostname (interned)"),
    num("ncpus", "ncpus", "Online CPU cores"),
    num("nnuma", "nnuma", "NUMA nodes"),
    num("rammb", "rammb", "RAM MB"),
    num("swapmb", "swapmb", "Swap MB"),
    num("boot", "boot", "Boot time (epoch sec)"),
    string("kernverstr", "kernverstr", "Kernel version"),
    string("dist", "dist", "OS distribution"),
    string("cputype", "cputype", "Processor model"),
    string("instanceid", "instanceid", "Cloud instance id"),
    string("region", "region", "Cloud region"),
    string("zone", "zone", "Cloud zone"),
    string("virt", "virt", "Virtualization (none/vm/container)"),
    string("cloud", "cloud", "Cloud provider (none/aws/gcp/azure)"),
    boolean("isk8s", "isk8s", "Kubernetes node"),
)

# ------------------------------------------------------------ cgroupstate
# ref cgroupstate subsystem (CGROUP_HANDLE stats, common/gy_cgroup_stat.h)
CGROUPSTATE_FIELDS = (
    string("cgid", "cgid", "Cgroup path hash (hex)"),
    string("dir", "dir", "Cgroup path (interned)"),
    num("hostid", "hostid", "Host id"),
    num("cpupct", "cpupct", "CPU %"),
    num("cpulimpct", "cpulimpct", "CPU limit % (<0 none)"),
    num("throttlepct", "throttlepct", "Throttled period fraction %"),
    num("rssmb", "rssmb", "Resident memory MB"),
    num("memlimmb", "memlimmb", "Memory limit MB (<0 none)"),
    num("pgmajfps", "pgmajfps", "Major page faults/sec"),
    num("nprocs", "nprocs", "Processes in cgroup"),
    boolean("isv2", "isv2", "cgroup v2 unified hierarchy"),
    enum("state", "state", _state_enc, _state_dec,
         "Cgroup pressure state"),
)

# ----------------------------------------------------------- alerts tier
# ref shyama alert subsystems (gy_json_field_maps.h SUBSYS_ALERTS /
# ALERTDEF / SILENCES / INHIBITS; ALERTMGR state, gy_alertmgr.h:948)
ALERTS_FIELDS = (
    num("tfired", "tfired", "Fire time (epoch sec)"),
    string("alertname", "alertname", "Alert definition name"),
    string("severity", "severity", "Severity"),
    string("subsys", "subsys", "Subsystem evaluated"),
    string("entity", "entity", "Entity key (svcid=… / hostid=…)"),
    string("labels", "labels", "Labels (JSON)"),
    string("annotations", "annotations", "Annotations (JSON)"),
)

ALERTDEF_FIELDS = (
    string("alertname", "alertname", "Definition name"),
    string("subsys", "subsys", "Subsystem"),
    string("filter", "filter", "Criteria filter"),
    string("severity", "severity", "Severity"),
    string("mode", "mode", "realtime | db"),
    num("numcheckfor", "numcheckfor", "Consecutive hits to fire"),
    num("repeataftersec", "repeataftersec", "Re-notify holdoff sec"),
    num("querysec", "querysec", "DB-mode period sec"),
    num("groupwaitsec", "groupwaitsec", "Group-wait sec"),
    boolean("enabled", "enabled", "Definition enabled"),
    num("nfiring", "nfiring", "Entities currently firing"),
)

SILENCES_FIELDS = (
    string("name", "name", "Silence name"),
    string("filter", "filter", "Criteria filter (empty = all)"),
    string("alertnames", "alertnames", "Alert names muted (empty = any)"),
    num("tstart", "tstart", "Active from (epoch sec)"),
    num("tend", "tend", "Active until (epoch sec)"),
    boolean("active", "active", "Currently in effect"),
)

INHIBITS_FIELDS = (
    string("name", "name", "Inhibit rule name"),
    string("srcalerts", "srcalerts", "Source alert names"),
    string("targetalerts", "targetalerts", "Suppressed alert names"),
    boolean("active", "active", "A source alert is currently firing"),
)

ACTIONS_FIELDS = (
    string("name", "name", "Action name (alertdef routing target)"),
    string("type", "type", "Delivery type (builtin/webhook/slack/"
                           "email/pagerduty)"),
    string("target", "target", "Delivery URL ('' for builtins)"),
    num("ndefs", "ndefs", "Alert definitions routing to this action"),
)

FIELDS_OF_SUBSYS = {
    SUBSYS_SVCSTATE: SVCSTATE_FIELDS,
    SUBSYS_HOSTSTATE: HOSTSTATE_FIELDS,
    SUBSYS_CLUSTERSTATE: CLUSTERSTATE_FIELDS,
    SUBSYS_FLOWSTATE: FLOWSTATE_FIELDS,
    SUBSYS_TASKSTATE: TASKSTATE_FIELDS,
    SUBSYS_TOPCPU: TASKSTATE_FIELDS,
    SUBSYS_TOPPGCPU: TASKSTATE_FIELDS,
    SUBSYS_PROCINFO: PROCINFO_FIELDS,
    SUBSYS_TOPRSS: TASKSTATE_FIELDS,
    SUBSYS_TOPDELAY: TASKSTATE_FIELDS,
    SUBSYS_TOPFORK: TASKSTATE_FIELDS,
    SUBSYS_SVCDEP: SVCDEP_FIELDS,
    SUBSYS_SVCMESH: SVCMESH_FIELDS,
    SUBSYS_CPUMEM: CPUMEM_FIELDS,
    SUBSYS_TRACEREQ: TRACEREQ_FIELDS,
    SUBSYS_SVCINFO: SVCINFO_FIELDS,
    SUBSYS_ACTIVECONN: ACTIVECONN_FIELDS,
    SUBSYS_HOSTINFO: HOSTINFO_FIELDS,
    SUBSYS_CGROUPSTATE: CGROUPSTATE_FIELDS,
    SUBSYS_SVCSUMM: SVCSUMM_FIELDS,
    SUBSYS_EXTSVCSTATE: EXTSVCSTATE_FIELDS,
    SUBSYS_CLIENTCONN: CLIENTCONN_FIELDS,
    SUBSYS_SVCPROCMAP: SVCPROCMAP_FIELDS,
    SUBSYS_NOTIFYMSG: NOTIFYMSG_FIELDS,
    SUBSYS_HOSTLIST: HOSTLIST_FIELDS,
    SUBSYS_SERVERSTATUS: SERVERSTATUS_FIELDS,
    SUBSYS_TRACEDEF: TRACEDEF_FIELDS,
    SUBSYS_TRACESTATUS: TRACESTATUS_FIELDS,
    SUBSYS_TRACEUNIQ: TRACEUNIQ_FIELDS,
    SUBSYS_TRACECONN: TRACECONN_FIELDS,
    SUBSYS_TAGS: TAGS_FIELDS,
    SUBSYS_MOUNTSTATE: MOUNTSTATE_FIELDS,
    SUBSYS_NETIF: NETIF_FIELDS,
    SUBSYS_EXTACTIVECONN: EXTACTIVECONN_FIELDS,
    SUBSYS_EXTCLIENTCONN: EXTCLIENTCONN_FIELDS,
    SUBSYS_EXTTRACEREQ: EXTTRACEREQ_FIELDS,
    SUBSYS_SHARDLIST: SHARDLIST_FIELDS,
    SUBSYS_SVCIPCLUST: SVCIPCLUST_FIELDS,
    SUBSYS_TOPK: TOPK_FIELDS,
    SUBSYS_ALERTS: ALERTS_FIELDS,
    SUBSYS_ALERTDEF: ALERTDEF_FIELDS,
    SUBSYS_SILENCES: SILENCES_FIELDS,
    SUBSYS_INHIBITS: INHIBITS_FIELDS,
    SUBSYS_ACTIONS: ACTIONS_FIELDS,
}


def check_subsys(subsys: str) -> str:
    """Validate a subsystem NAME at definition time → the name, or a
    ValueError that lists every valid subsystem. Alert/trace defs call
    this when they are CREATED so a typo'd subsys fails the CRUD
    request with an actionable message instead of surfacing as a
    fold-time evaluation error on every subsequent tick."""
    if subsys not in FIELDS_OF_SUBSYS:
        raise ValueError(f"unknown subsystem {subsys!r}; "
                         f"one of {sorted(FIELDS_OF_SUBSYS)}")
    return subsys


def field_map(subsys: str) -> dict[str, FieldDef]:
    try:
        return {f.json: f for f in FIELDS_OF_SUBSYS[subsys]}
    except KeyError:
        raise ValueError(f"unknown subsystem {subsys!r}; "
                         f"one of {sorted(FIELDS_OF_SUBSYS)}")


def row_to_json(subsys: str, row: dict) -> dict:
    """Apply enum/bool codecs for presentation (statetojson analogues)."""
    out = {}
    for f in FIELDS_OF_SUBSYS[subsys]:
        if f.col not in row:
            continue
        v = row[f.col]
        if f.kind == "enum":
            out[f.json] = f.to_json(v)
        elif f.kind == "bool":
            out[f.json] = bool(v)
        elif f.kind == "num":
            fv = float(v)
            out[f.json] = int(fv) if fv.is_integer() else round(fv, 3)
        else:
            out[f.json] = v
    return out
