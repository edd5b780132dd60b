"""Version gate (ref: partha/sversion.cc, server/mversion.cc — registration
version gating per common/gy_comm_proto.h:55-56).

A copy of ``gyeeta_tpu/version.py`` (no JAX): the port imports nothing of
the JAX package.
"""

__version__ = "0.1.0"

# Minimum wire-format version this build accepts from agents/simulators.
MIN_WIRE_VERSION = 3   # v2: AGGR_TASK_DT grew forks_sec (TOPFORK);
CURR_WIRE_VERSION = 5  # v3: REQ_TRACE_DT grew conn_id/cli ids
#                        (TRACECONN) — older record layouts cannot be
#                        decoded, so the registration gate must reject
#                        older producers outright.
#                        v4: durable-ingest additions only (SWEEP_SEQ
#                        marks, COMM_THROTTLE control, REGISTER_RESP
#                        last_seq tail) — no existing layout changed,
#                        so v3 producers stay accepted (MIN stays 3);
#                        v3 peers skip the new subtype/control frames.
#                        v5: edge pre-aggregation (NOTIFY_SKETCH_DELTA
#                        + the REGISTER_RESP preagg advert tail) —
#                        additive again: v3/v4 servers skip the new
#                        subtype COUNTED, v3/v4 agents ignore the
#                        advert tail and stay raw (MIN stays 3)
