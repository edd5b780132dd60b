// ABI compile probe: the minimal extracted header subset of every
// stock gy_comm_proto struct this repo adapts (ingest/refproto.py
// transcribes the ingest half, ingest/refquery.py the query half).
//
// This TU is the C++-compiler side of the proof: abiprobe.py appends a
// generated main() that prints offsetof/sizeof for every field of every
// numpy transcription, compiles the pair with the host toolchain, and
// tests/test_refproto.py asserts the emitted layout equals the numpy
// layout field-for-field. A transcription whose explicit padding
// disagrees with what a real C++ compiler lays out fails loudly; a
// numpy field missing here fails the generated main's compile.
//
// Conventions mirrored from the reference headers (gy_comm_proto.h,
// gy_common_inc.h): little-endian POD structs, natural member
// alignment with EXPLICIT padding members on the wire structs, and
// GY_IP_ADDR carrying the reference's packed+aligned(8) attribute.
// Field names match the numpy transcription 1:1 (the reference's
// trailing-underscore style dropped so the generated emission lines
// need no mapping).

#include <cstdint>
#include <cstddef>

namespace gyt_abi {

// ------------------------------------------------------------ framing
struct COMM_HEADER {            // gy_comm_proto.h:336
  uint32_t magic;
  uint32_t total_sz;
  uint32_t data_type;
  uint32_t padding_sz;
};

struct EVENT_NOTIFY {           // gy_comm_proto.h:486
  uint32_t subtype;
  uint32_t nevents;
};

// ------------------------------------------------------------- address
struct alignas(8) GY_IP_ADDR {  // gy_common_inc.h:10492 (packed,
  uint8_t ip128[16];            // aligned(8): members are naturally
  uint32_t ip32_be;             // packed already)
  int16_t aftype;
  uint16_t ipflags;
};

struct IP_PORT {                // gy_common_inc.h:11162
  uint8_t ip128[16];            // embedded GY_IP_ADDR content
  uint32_t ip32_be;
  int16_t aftype;
  uint16_t ipflags;
  uint16_t port;
  uint8_t pad[6];
};

// ------------------------------------------------------ event notifies
struct TCP_CONN_NOTIFY {        // gy_comm_proto.h:1665
  IP_PORT cli;
  IP_PORT ser;
  IP_PORT nat_cli;
  IP_PORT nat_ser;
  uint64_t tusec_start;
  uint64_t tusec_close;
  uint64_t cli_task_aggr_id;
  uint64_t cli_related_listen_id;
  uint64_t cli_madhava_id;
  uint64_t machid_hi;
  uint64_t machid_lo;
  uint64_t ser_related_listen_id;
  uint64_t ser_glob_id;
  uint64_t ser_madhava_id;
  uint64_t bytes_sent;
  uint64_t bytes_rcvd;
  int32_t cli_pid;
  int32_t ser_pid;
  uint32_t ser_conn_hash;
  uint32_t ser_sock_inode;
  char cli_comm[16];
  char ser_comm[16];
  uint16_t cli_cmdline_len;
  uint8_t is_connect;
  uint8_t is_accept;
  uint8_t is_loopback;
  uint8_t is_pre_existing;
  uint8_t notified_before;
  uint8_t padding_len;
};

struct LISTENER_STATE_NOTIFY {  // gy_comm_proto.h:2183
  uint64_t glob_id;
  uint32_t nqrys_5s;
  uint32_t total_resp_5sec;
  uint32_t nconns;
  uint32_t nconns_active;
  uint32_t ntasks;
  uint32_t p95_5s_resp_ms;
  uint32_t p95_5min_resp_ms;
  uint32_t curr_kbytes_inbound;
  uint32_t curr_kbytes_outbound;
  uint32_t ser_errors;
  uint32_t cli_errors;
  uint32_t tasks_delay_usec;
  uint32_t tasks_cpudelay_usec;
  uint32_t tasks_blkiodelay_usec;
  uint32_t tasks_user_cpu;
  uint32_t tasks_sys_cpu;
  uint32_t tasks_rss_mb;
  uint16_t ntasks_issue;
  uint8_t is_http_svc;
  uint8_t curr_state;
  uint8_t curr_issue;
  uint8_t issue_bit_hist;
  uint8_t high_resp_bit_hist;
  uint8_t last_issue_subsrc;
  uint8_t query_flags;
  uint8_t issue_string_len;
  uint8_t padding_len;
  uint8_t tailpad[1];
};

struct AGGR_TASK_STATE_NOTIFY { // gy_comm_proto.h:2114
  uint64_t aggr_task_id;
  char onecomm[16];
  int32_t pid_arr[2];
  uint32_t tcp_kbytes;
  uint32_t tcp_conns;
  float total_cpu_pct;
  uint32_t rss_mb;
  uint32_t cpu_delay_msec;
  uint32_t vm_delay_msec;
  uint32_t blkio_delay_msec;
  uint16_t ntasks_total;
  uint16_t ntasks_issue;
  uint8_t curr_state;
  uint8_t curr_issue;
  uint8_t issue_bit_hist;
  uint8_t severe_issue_bit_hist;
  uint8_t issue_string_len;
  uint8_t padding_len;
  uint8_t tailpad[2];
};

struct NEW_LISTENER {           // gy_comm_proto.h:1531
  IP_PORT ns_ip_port;           // NS_IP_PORT head (gy_inet_inc.h:105)
  uint64_t inode;               // ... its netns inode tail
  uint64_t glob_id;
  uint64_t aggr_glob_id;
  uint64_t related_listen_id;
  uint64_t tstart_usec;
  uint64_t ser_aggr_task_id;
  uint8_t is_any_ip;
  uint8_t is_pre_existing;
  uint8_t no_aggr_stats;
  uint8_t no_resp_stats;
  char comm[16];
  int32_t start_pid;
  uint16_t cmdline_len;
  uint8_t padding_len;
  uint8_t tailpad[5];
};

struct ACTIVE_CONN_STATS {      // gy_comm_proto.h:2766
  uint64_t listener_glob_id;
  uint64_t cli_aggr_task_id;
  char ser_comm[16];
  char cli_comm[16];
  uint64_t machid_hi;
  uint64_t machid_lo;
  uint64_t remote_madhava_id;
  uint64_t bytes_sent;
  uint64_t bytes_received;
  uint32_t cli_delay_msec;
  uint32_t ser_delay_msec;
  float max_rtt_msec;
  uint16_t active_conns;
  uint8_t connflags;
  uint8_t tailpad[1];
};

struct TASK_TOP_HDR {           // gy_comm_proto.h:1415
  uint16_t nprocs;
  uint16_t npg_procs;
  uint16_t nrss_procs;
  uint16_t nfork_procs;
  uint16_t ext_data_len;
  uint8_t tailpad[6];
};

struct TASK_TOP_PROC {
  uint64_t aggr_task_id;
  int32_t pid;
  int32_t ppid;
  uint32_t rss_mb;
  float cpupct;
  char comm[16];
};

struct TASK_TOP_PG {
  uint64_t aggr_task_id;
  int32_t pg_pid;
  int32_t cpid;
  int32_t ntasks;
  uint32_t tot_rss_mb;
  float tot_cpupct;
  char pg_comm[16];
  char child_comm[16];
  uint8_t tailpad[4];
};

struct TASK_TOP_FORK {
  uint64_t aggr_task_id;
  int32_t pid;
  int32_t ppid;
  int32_t nfork_per_sec;
  char comm[16];
  uint8_t tailpad[4];
};

struct TASK_AGGR_NOTIFY {       // gy_comm_proto.h:1290
  uint64_t aggr_task_id;
  uint64_t related_listen_id;
  char comm[16];
  uint32_t uid;
  uint32_t gid;
  uint16_t cmdline_len;
  uint8_t tag_len;
  uint8_t procflags;
  uint8_t padding_len;
  uint8_t tailpad[3];
};

struct PING_TASK_AGGR {         // gy_comm_proto.h:1384
  uint64_t aggr_task_id;
};

struct PARTHA_STATUS {          // gy_comm_proto.h:1399
  uint8_t is_ok;
  uint8_t pad0[7];
  int64_t curr_sec;
  int64_t clock_sec;
};

struct CPU_MEM_STATE_NOTIFY {   // gy_comm_proto.h:2024
  float cpu_pct;
  float usercpu_pct;
  float syscpu_pct;
  float iowait_pct;
  float cumul_core_cpu_pct;
  uint32_t forks_sec;
  uint32_t procs_running;
  uint32_t cs_sec;
  uint32_t cs_p95_sec;
  uint32_t cs_5min_p95_sec;
  uint32_t cpu_p95;
  uint32_t cpu_5min_p95;
  uint32_t fork_p95_sec;
  uint32_t fork_5min_p95_sec;
  uint32_t procs_p95;
  uint32_t procs_5min_p95;
  uint8_t cpu_state;
  uint8_t cpu_issue;
  uint8_t cpu_issue_bit_hist;
  uint8_t cpu_severe_issue_hist;
  uint8_t cpu_state_string_len;
  uint8_t pad0[3];
  float rss_pct;
  uint8_t pad1[4];
  uint64_t rss_memory_mb;
  uint64_t total_memory_mb;
  uint64_t cached_memory_mb;
  uint64_t locked_memory_mb;
  uint64_t committed_memory_mb;
  float committed_pct;
  uint8_t pad2[4];
  uint64_t swap_free_mb;
  uint64_t swap_total_mb;
  uint32_t pg_inout_sec;
  uint32_t swap_inout_sec;
  uint32_t reclaim_stalls;
  uint32_t pgmajfault;
  uint32_t oom_kill;
  uint32_t rss_pct_p95;
  uint64_t pginout_p95;
  uint64_t swpinout_p95;
  uint64_t allocstall_p95;
  uint8_t mem_state;
  uint8_t mem_issue;
  uint8_t mem_issue_bit_hist;
  uint8_t mem_severe_issue_hist;
  uint8_t mem_state_string_len;
  uint8_t padding_len;
  uint8_t tailpad[2];
};

struct HOST_STATE_NOTIFY {      // gy_comm_proto.h:2289
  uint64_t curr_time_usec;
  uint32_t ntasks_issue;
  uint32_t ntasks_severe;
  uint32_t ntasks;
  uint32_t nlisten_issue;
  uint32_t nlisten_severe;
  uint32_t nlisten;
  uint8_t curr_state;
  uint8_t issue_bit_hist;
  uint8_t cpu_issue;
  uint8_t mem_issue;
  uint8_t severe_cpu_issue;
  uint8_t severe_mem_issue;
  uint8_t pad0[2];
  uint32_t total_cpu_delayms;
  uint32_t total_vm_delayms;
  uint32_t total_io_delayms;
  uint8_t tailpad[4];
};

struct HOST_INFO_NOTIFY {       // gy_comm_proto.h:2844
  char distribution_name[128];
  char kern_version_string[64];
  uint32_t kern_version_num;
  char instance_id[128];
  char cloud_type[64];
  char processor_model[128];
  char cpu_vendor[64];
  uint16_t cores_online;
  uint16_t cores_offline;
  uint16_t max_cores;
  uint16_t isolated_cores;
  uint32_t ram_mb;
  uint32_t corrupted_ram_mb;
  uint16_t num_numa_nodes;
  uint16_t max_cores_per_socket;
  uint16_t threads_per_core;
  uint8_t pad0[6];
  int64_t boot_time_sec;
  uint32_t l1_dcache_kb;
  uint32_t l2_cache_kb;
  uint32_t l3_cache_kb;
  uint32_t l4_cache_kb;
  uint8_t is_virtual_cpu;
  char virtualization_type[64];
  uint8_t tailpad[7];
};

struct NAT_TCP_NOTIFY {         // gy_comm_proto.h:1744
  IP_PORT orig_cli;
  IP_PORT orig_ser;
  IP_PORT nat_cli;
  IP_PORT nat_ser;
  uint8_t is_snat;
  uint8_t is_dnat;
  uint8_t is_ipvs;
  uint8_t tailpad[5];
};

struct API_TRAN {               // gy_proto_common.h:140
  uint64_t treq_usec;
  uint64_t tres_usec;
  uint64_t tupd_usec;
  uint64_t reqlen;
  uint64_t reslen;
  uint64_t reqnum;
  uint64_t response_usec;
  uint64_t reaction_usec;
  uint64_t tconnect_usec;
  GY_IP_ADDR cliip;
  GY_IP_ADDR serip;
  uint64_t glob_id;
  uint64_t conn_id;
  char comm[16];
  int32_t errorcode;
  uint32_t app_sleep_ms;
  uint32_t tran_type;
  uint16_t proto;
  uint16_t cliport;
  uint16_t serport;
  uint16_t request_len;
  uint16_t lenext;
  uint8_t padlen;
  uint8_t tailpad[1];
};

struct HOST_CPU_MEM_CHANGE {    // gy_comm_proto.h:2886
  uint8_t cpu_changed;
  uint8_t pad0;
  uint16_t new_cores_online;
  uint16_t new_cores_offline;
  uint16_t old_cores_online;
  uint16_t old_cores_offline;
  uint8_t mem_changed;
  uint8_t pad1;
  uint32_t new_ram_mb;
  uint32_t old_ram_mb;
  uint8_t mem_corrupt_changed;
  uint8_t pad2[3];
  uint32_t new_corrupted_ram_mb;
  uint32_t old_corrupted_ram_mb;
};

struct NOTIFICATION_MSG {       // gy_comm_proto.h:2913
  uint8_t type;
  uint8_t pad0;
  uint16_t msglen;
  uint8_t padding_len;
  uint8_t tailpad[3];
};

struct LISTENER_DOMAIN_NOTIFY { // gy_comm_proto.h:2724
  uint64_t glob_id;
  uint8_t domain_string_len;
  uint8_t tag_len;
  uint8_t padding_len;
  uint8_t tailpad[5];
};

struct LISTEN_TASKMAP_NOTIFY {  // gy_comm_proto.h:2813
  uint64_t related_listen_id;
  char ser_comm[16];
  uint16_t nlisten;
  uint16_t naggr_taskid;
  uint8_t tailpad[4];
};

// --------------------------------------------------------- handshakes
struct PS_REGISTER_REQ_S {      // gy_comm_proto.h:584
  uint32_t comm_version;
  uint32_t partha_version;
  uint32_t min_shyama_version;
  uint8_t pad0[4];
  uint64_t machine_id_hi;
  uint64_t machine_id_lo;
  char hostname[256];
  char write_access_key[64];
  char cluster_name[64];
  char region_name[64];
  char zone_name[64];
  uint32_t kern_version_num;
  uint8_t pad1[4];
  int64_t curr_sec;
  int64_t last_mdisconn_sec;
  uint64_t last_madhava_id;
  uint64_t flags;
  uint8_t extra_bytes[512];
};

struct PS_REGISTER_RESP_S {     // gy_comm_proto.h:616
  int32_t error_code;
  char error_string[256];
  uint32_t comm_version;
  uint32_t shyama_version;
  uint8_t pad0[4];
  uint64_t shyama_id;
  uint64_t flags;
  uint64_t partha_ident_key;
  int64_t madhava_expiry_sec;
  uint64_t madhava_id;
  uint16_t madhava_port;
  char madhava_hostname[256];
  char madhava_name[64];
  uint8_t extra_bytes[800];
  uint8_t tailpad[6];
};

struct PM_CONNECT_CMD_S {       // gy_comm_proto.h:648
  uint32_t comm_version;
  uint32_t partha_version;
  uint32_t min_madhava_version;
  uint8_t pad0[4];
  uint64_t machine_id_hi;
  uint64_t machine_id_lo;
  uint64_t partha_ident_key;
  char hostname[256];
  char write_access_key[64];
  char cluster_name[64];
  char region_name[64];
  char zone_name[64];
  uint64_t madhava_id;
  uint32_t cli_type;
  uint32_t kern_version_num;
  int64_t curr_sec;
  int64_t clock_sec;
  int64_t process_uptime_sec;
  int64_t last_connect_sec;
  uint64_t flags;
  uint8_t extra_bytes[512];
};

struct PM_CONNECT_RESP_S {      // gy_comm_proto.h:691
  int32_t error_code;
  char error_string[256];
  uint8_t pad0[4];
  uint64_t madhava_id;
  uint32_t comm_version;
  uint32_t madhava_version;
  char region_name[64];
  char zone_name[64];
  char madhava_name[64];
  int64_t curr_sec;
  uint64_t clock_sec;
  uint64_t flags;
  uint8_t extra_bytes[512];
};

// ------------------------------------------------- node (NM) query edge
struct NM_CONNECT_CMD_S {       // gy_comm_proto.h:887
  uint32_t comm_version;
  uint32_t node_version;
  uint32_t min_madhava_version;
  uint8_t pad0[4];
  char node_hostname[256];
  uint32_t node_port;
  uint32_t cli_type;
  int64_t curr_sec;
  int64_t clock_sec;
  uint64_t flags;
  uint8_t extra_bytes[512];
};

struct NM_CONNECT_RESP_S {      // gy_comm_proto.h:923
  int32_t error_code;
  char error_string[256];
  uint8_t pad0[4];
  uint64_t madhava_id;
  uint32_t comm_version;
  uint32_t madhava_version;
  char madhava_name[64];
  int64_t curr_sec;
  uint64_t clock_sec;
  uint64_t flags;
  uint8_t extra_bytes[512];
};

struct QUERY_CMD_S {            // gy_comm_proto.h:502
  uint64_t seqid;
  uint64_t timeoutusec;
  uint32_t subtype;
  uint32_t respformat;
};

struct QUERY_RESPONSE_S {       // gy_comm_proto.h:536
  uint64_t seqid;
  uint32_t resptype;
  uint32_t respformat;
  uint32_t resp_len;
  uint32_t is_completed;
};

}  // namespace gyt_abi
