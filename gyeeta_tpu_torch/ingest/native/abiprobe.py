"""ABI compile probe: prove the numpy struct transcriptions against a
real C++ compiler's layout of the extracted header subset.

Counterpart of ``gyeeta_tpu/ingest/native/abiprobe.py`` (the port's own
copy, over the port's ``refproto``/``refquery`` dtypes).

``refproto.py``/``refquery.py`` transcribe the stock gy_comm_proto
structs as explicit numpy dtypes with hand-placed padding. This module
turns that transcription into proof: ``abiprobe.cpp`` carries the same
structs as plain C++ (natural member alignment, the reference's
explicit-padding/alignas conventions); a GENERATED main() — one
``offsetof``/``sizeof`` emission line per numpy field, derived from the
dtypes themselves — is appended, compiled with the host toolchain (the
same one that builds ``libgytdeframe.so``) and run. The emitted layout
must equal the numpy layout field-for-field:

- a numpy field missing from the C++ struct fails the compile;
- wrong explicit padding / misordered fields fail the offset compare;
- a size drift fails the sizeof compare.

``tests/test_torch_refproto.py`` asserts the full comparison; hosts without a
C++ toolchain skip WITH A LOGGED REASON (never silently).
"""

from __future__ import annotations

import pathlib
import subprocess
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "abiprobe.cpp"


def probed_structs() -> dict:
    """C++ struct name → numpy dtype, for EVERY adapted stock struct
    (ingest half from refproto, query half from refquery). A dtype
    added to either module must be registered here — the coverage test
    walks this table."""
    from gyeeta_tpu_torch.ingest import refproto as RP
    from gyeeta_tpu_torch.ingest import refquery as RQ

    return {
        "COMM_HEADER": RP.REF_HEADER_DT,
        "EVENT_NOTIFY": RP.REF_EVENT_NOTIFY_DT,
        "GY_IP_ADDR": RP.REF_GY_IP_ADDR_DT,
        "IP_PORT": RP.REF_IP_PORT_DT,
        "TCP_CONN_NOTIFY": RP.REF_TCP_CONN_DT,
        "LISTENER_STATE_NOTIFY": RP.REF_LISTENER_STATE_DT,
        "AGGR_TASK_STATE_NOTIFY": RP.REF_AGGR_TASK_DT,
        "NEW_LISTENER": RP.REF_NEW_LISTENER_DT,
        "ACTIVE_CONN_STATS": RP.REF_ACTIVE_CONN_DT,
        "TASK_TOP_HDR": RP.REF_TOP_HDR_DT,
        "TASK_TOP_PROC": RP.REF_TOP_TASK_DT,
        "TASK_TOP_PG": RP.REF_TOP_PG_DT,
        "TASK_TOP_FORK": RP.REF_TOP_FORK_DT,
        "TASK_AGGR_NOTIFY": RP.REF_TASK_AGGR_DT,
        "PING_TASK_AGGR": RP.REF_PING_TASK_AGGR_DT,
        "PARTHA_STATUS": RP.REF_PARTHA_STATUS_DT,
        "CPU_MEM_STATE_NOTIFY": RP.REF_CPU_MEM_DT,
        "HOST_STATE_NOTIFY": RP.REF_HOST_STATE_DT,
        "HOST_INFO_NOTIFY": RP.REF_HOST_INFO_DT,
        "NAT_TCP_NOTIFY": RP.REF_NAT_TCP_DT,
        "API_TRAN": RP.REF_API_TRAN_DT,
        "HOST_CPU_MEM_CHANGE": RP.REF_CPU_MEM_CHANGE_DT,
        "NOTIFICATION_MSG": RP.REF_NOTIFICATION_MSG_DT,
        "LISTENER_DOMAIN_NOTIFY": RP.REF_LISTENER_DOMAIN_DT,
        "LISTEN_TASKMAP_NOTIFY": RP.REF_LISTEN_TASKMAP_DT,
        "PS_REGISTER_REQ_S": RP.REF_PS_REGISTER_REQ_DT,
        "PS_REGISTER_RESP_S": RP.REF_PS_REGISTER_RESP_DT,
        "PM_CONNECT_CMD_S": RP.REF_PM_CONNECT_CMD_DT,
        "PM_CONNECT_RESP_S": RP.REF_PM_CONNECT_RESP_DT,
        "NM_CONNECT_CMD_S": RQ.REF_NM_CONNECT_CMD_DT,
        "NM_CONNECT_RESP_S": RQ.REF_NM_CONNECT_RESP_DT,
        "QUERY_CMD_S": RQ.REF_QUERY_CMD_DT,
        "QUERY_RESPONSE_S": RQ.REF_QUERY_RESPONSE_DT,
    }


def numpy_layout(dt: np.dtype) -> dict:
    """dtype → {"__sizeof__": itemsize, field: (offset, size)}."""
    out = {"__sizeof__": dt.itemsize}
    for name in dt.names:
        sub, off = dt.fields[name][:2]
        out[name] = (off, sub.itemsize)
    return out


def _gen_main(structs: dict) -> str:
    """The generated TU: include the header subset + emit one line per
    numpy field. ``sizeof`` of a member via the null-deref idiom so
    array members report their full extent."""
    lines = [
        '#include <cstdio>',
        f'#include "{SRC}"',
        'using namespace gyt_abi;',
        '#define P(S, f) std::printf("%s %s %zu %zu\\n", #S, #f, '
        'offsetof(S, f), sizeof ((S*)0)->f)',
        '#define SZ(S) std::printf("%s __sizeof__ %zu %zu\\n", #S, '
        'sizeof(S), alignof(S))',
        'int main() {',
    ]
    for sname, dt in structs.items():
        lines.append(f'  SZ({sname});')
        for field in dt.names:
            lines.append(f'  P({sname}, {field});')
    lines += ['  return 0;', '}', '']
    return "\n".join(lines)


def toolchain() -> str | None:
    import shutil
    from gyeeta_tpu_torch.ingest.native import build
    cxx = build.CXX
    return cxx if shutil.which(cxx) else None


def run_probe(structs: dict | None = None) -> dict | None:
    """Compile + run the probe → {struct: {"__sizeof__": n, field:
    (offset, size)}} as the C++ COMPILER lays it out, or None when the
    host has no toolchain (callers log the skip reason)."""
    if structs is None:
        structs = probed_structs()
    cxx = toolchain()
    if cxx is None:
        return None
    with tempfile.TemporaryDirectory(prefix="gyt_abiprobe") as td:
        main_cpp = pathlib.Path(td) / "abiprobe_main.cpp"
        exe = pathlib.Path(td) / "abiprobe"
        main_cpp.write_text(_gen_main(structs))
        subprocess.run(
            [cxx, "-O0", "-std=c++17", "-Wall", "-Werror",
             str(main_cpp), "-o", str(exe)],
            check=True, capture_output=True, text=True)
        txt = subprocess.run([str(exe)], check=True,
                             capture_output=True, text=True).stdout
    out: dict = {}
    for ln in txt.splitlines():
        sname, field, a, b = ln.split()
        if field == "__sizeof__":
            out.setdefault(sname, {})["__sizeof__"] = int(a)
        else:
            out.setdefault(sname, {})[field] = (int(a), int(b))
    return out


def compare(cxx_layout: dict, structs: dict | None = None) -> list:
    """C++ layout vs numpy layout → list of mismatch strings (empty =
    every adapted struct is byte-compatible with the compiler)."""
    if structs is None:
        structs = probed_structs()
    bad = []
    for sname, dt in structs.items():
        got = cxx_layout.get(sname)
        if got is None:
            bad.append(f"{sname}: missing from probe output")
            continue
        want = numpy_layout(dt)
        if got["__sizeof__"] != want["__sizeof__"]:
            bad.append(f"{sname}: sizeof {got['__sizeof__']} != "
                       f"numpy itemsize {want['__sizeof__']}")
        for field in dt.names:
            g = got.get(field)
            if g is None:
                bad.append(f"{sname}.{field}: not emitted")
            elif g != want[field]:
                bad.append(
                    f"{sname}.{field}: C++ (off={g[0]}, sz={g[1]}) != "
                    f"numpy (off={want[field][0]}, sz={want[field][1]})")
    return bad


def main() -> int:
    import sys
    layout = run_probe()
    if layout is None:
        print("abiprobe: SKIP — no C++ toolchain on this host",
              file=sys.stderr)
        return 0
    bad = compare(layout)
    ns = len(probed_structs())
    if bad:
        print(f"abiprobe: {len(bad)} mismatch(es) across {ns} structs:",
              file=sys.stderr)
        for b in bad:
            print(f"  {b}", file=sys.stderr)
        return 1
    nf = sum(len(dt.names) for dt in probed_structs().values())
    print(f"abiprobe: OK — {ns} structs / {nf} fields byte-compatible",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
