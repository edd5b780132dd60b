"""State and issue-source enums (a copy of
``gyeeta_tpu/semantic/states.py``): six object states and the issue
sources of services, process groups and host cpu/memory."""

STATE_IDLE = 0
STATE_GOOD = 1
STATE_OK = 2
STATE_BAD = 3
STATE_SEVERE = 4
STATE_DOWN = 5

STATE_NAMES = ("Idle", "Good", "OK", "Bad", "Severe", "Down")

ISSUE_NONE = 0
ISSUE_TASKS = 1           # ISSUE_LISTENER_TASKS
ISSUE_QPS_HIGH = 2
ISSUE_ACTIVE_CONN_HIGH = 3
ISSUE_SERVER_ERRORS = 4
ISSUE_OS_CPU = 5
ISSUE_OS_MEMORY = 6

ISSUE_NAMES = ("none", "listener_tasks", "qps_high", "active_conn_high",
               "server_errors", "os_cpu", "os_memory")

# process-group (aggregate task) issue sources
TISSUE_NONE = 0
TISSUE_CPU_DELAY = 1
TISSUE_BLKIO_DELAY = 2
TISSUE_VM_DELAY = 3
TISSUE_HIGH_CPU = 4
TISSUE_HIGH_RSS = 5

TASK_ISSUE_NAMES = ("none", "cpu_delay", "blkio_delay", "vm_delay",
                    "high_cpu", "high_rss")

# host cpu/mem issue sources of the 2s path
CISSUE_NONE = 0
CISSUE_CPU_SATURATED = 1
CISSUE_CORE_SATURATED = 2
CISSUE_IOWAIT = 3
CISSUE_CONTEXT_SWITCH = 4
CISSUE_FORKS = 5
CISSUE_PROCS_RUNNING = 6

CPU_ISSUE_NAMES = ("none", "cpu_saturated", "core_saturated", "iowait",
                   "context_switch", "new_forks", "procs_running")

MISSUE_NONE = 0
MISSUE_RSS = 1
MISSUE_COMMIT = 2
MISSUE_SWAP_FULL = 3
MISSUE_SWAP_IO = 4
MISSUE_RECLAIM_STALLS = 5
MISSUE_PAGE_IO = 6
MISSUE_OOM_KILL = 7

MEM_ISSUE_NAMES = ("none", "rss_pct", "commit_pct", "swap_full",
                   "swap_io", "reclaim_stalls", "page_io", "oom_kill")
