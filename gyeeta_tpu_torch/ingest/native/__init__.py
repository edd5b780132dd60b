"""ctypes binding of the port's native deframer and columnar decoder.

Counterpart of ``gyeeta_tpu/ingest/native/__init__.py``: ``drain2(buf)``
walks a byte stream once in C++ (``deframe.cpp``) → {subtype: contiguous
record array}, bytes consumed and the records of unknown subtypes; the
columnar kernels ``decode_conn_into`` / ``decode_resp_into`` and the
generic ``split_u64_into`` / ``pack_f32_into`` / ``pack_i32_into`` write
raw record arrays straight into caller-provided column buffers at a lane
offset — numpy arrays, or the ``.numpy()`` views of the runtime's pinned
staging slabs. Column plans (field offset + scalar kind) are compiled
here from the ``wire`` dtypes and pushed into the library, never
compiled in, so it cannot drift from ``wire.py``.

The library is built with ``g++`` at first use (``build.py``, into
``build/native/``). A failed build or load raises: there is no silent
fallback. The numpy path stays selectable by the caller
(``Runtime(..., deframe="python")``, the builders' ``native=False``),
bit for bit the same output.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.ingest.native import build

_lib = None
_lock = threading.Lock()

_ERRNAMES = {1: "bad magic", 2: "bad total_sz", 3: "batch cap exceeded",
             4: "nevents does not fill frame", 5: "output buffer full",
             6: "bad subtype table",
             7: "unexpected data_type on event stream",
             8: "payload checksum mismatch"}
# rc → FrameError.reason (the labels the Python decoder raises with)
_ERRREASON = {1: "bad_magic", 2: "bad_size", 3: "bad_size",
              4: "bad_size", 6: "bad_frame", 7: "bad_dtype",
              8: "checksum"}

# drain2() output order, derived from wire.py
_SCAN_ORDER = tuple(sorted(wire.DTYPE_OF_SUBTYPE))

# scalar kind codes of the C++ pack kernels (deframe.cpp PackKind)
_KIND = {("u", 1): 1, ("u", 2): 2, ("u", 4): 3, ("u", 8): 4,
         ("i", 4): 5, ("f", 4): 6}

_CONN_ID_COLS = ("svc_hi", "svc_lo", "flow_hi", "flow_lo", "cli_hi",
                 "cli_lo", "cli_task_hi", "cli_task_lo", "cli_rel_hi",
                 "cli_rel_lo")
_CONN_COLS = _CONN_ID_COLS + ("bytes_sent", "bytes_rcvd", "duration_us",
                              "host_id", "is_close", "is_accept")


def lib() -> ctypes.CDLL:
    """The loaded library (built at first use); raises when it cannot
    be built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build.build())))
    return _lib


def _bind(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp = ctypes.c_void_p
    sigs = {
        "gyt_set_table": [i64p, ctypes.c_int32],
        "gyt_layout": [i64p, ctypes.c_int64],
        "gyt_extract_multi": [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(vp), i64p, i64p, i64p],
        "gyt_scan2": [ctypes.c_char_p, ctypes.c_int64, i64p, i64p, i64p],
        "gyt_set_conn_layout": [i64p, ctypes.c_int32],
        "gyt_decode_conn": [vp, ctypes.c_int64] + [vp] * 16,
        "gyt_decode_conn_i64": [vp, ctypes.c_int64] + [vp] * 16,
        "gyt_set_resp_layout": [i64p, ctypes.c_int32],
        "gyt_decode_resp": [vp, ctypes.c_int64] + [vp] * 4,
        "gyt_decode_resp_i64": [vp, ctypes.c_int64] + [vp] * 4,
        "gyt_pack_f32": [vp, ctypes.c_int64, ctypes.c_int64, i64p,
                         ctypes.c_int32, vp],
        "gyt_split_u64": [vp, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int64, vp, vp],
        "gyt_pack_i32": [vp, ctypes.c_int64, ctypes.c_int64,
                         ctypes.c_int64, ctypes.c_int64, vp],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = args
    # push the subtype table from wire.py, and check its echo
    n = len(_SCAN_ORDER)
    tri = (ctypes.c_int64 * (3 * n))()
    for i, st in enumerate(_SCAN_ORDER):
        tri[i * 3: i * 3 + 3] = [st, wire.DTYPE_OF_SUBTYPE[st].itemsize,
                                 wire.MAX_OF_SUBTYPE[st]]
    _check(lib.gyt_set_table(tri, n), "gyt_set_table")
    back = (ctypes.c_int64 * (3 * n))()
    got = lib.gyt_layout(back, n)
    native = {int(back[i * 3]): (int(back[i * 3 + 1]), int(back[i * 3 + 2]))
              for i in range(got)}
    expect = {st: (wire.DTYPE_OF_SUBTYPE[st].itemsize,
                   wire.MAX_OF_SUBTYPE[st]) for st in _SCAN_ORDER}
    if native != expect:
        raise RuntimeError(
            f"native deframer layout mismatch: {native} != {expect}")
    # the conn and resp decoders' record layouts
    dt = wire.TCP_CONN_DT
    off = {name: dt.fields[name][1] for name in dt.names}
    fields = [dt.itemsize,
              off["cli"], off["ser"], off["nat_cli"], off["nat_ser"],
              off["tusec_start"], off["tusec_close"],
              off["cli_task_aggr_id"], off["cli_related_listen_id"],
              off["ser_glob_id"], off["bytes_sent"], off["bytes_rcvd"],
              off["host_id"], off["flags"],
              wire.IP_PORT_DT.fields["port"][1]]
    _check(lib.gyt_set_conn_layout((ctypes.c_int64 * 15)(*fields), 15),
           "gyt_set_conn_layout")
    rdt = wire.RESP_SAMPLE_DT
    rfields = [rdt.itemsize, rdt.fields["glob_id"][1],
               rdt.fields["resp_usec"][1], rdt.fields["host_id"][1]]
    _check(lib.gyt_set_resp_layout((ctypes.c_int64 * 4)(*rfields), 4),
           "gyt_set_resp_layout")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: {_ERRNAMES.get(rc, rc)}")


def _ptr(a: np.ndarray, off: int = 0):
    """ctypes pointer to lane ``off`` of a contiguous column."""
    if not a.flags.c_contiguous:
        raise ValueError("native decode needs C-contiguous columns")
    return ctypes.c_void_p(a.ctypes.data + off * a.strides[0])


def _recs_ptr(recs: np.ndarray):
    recs = np.ascontiguousarray(recs)
    # the caller keeps the array alive for the call
    return recs, recs.ctypes.data_as(ctypes.c_void_p)


# column plans: (dtype, fields) → compiled (src_off, kind) int64 array
_PLANS: dict = {}


def _plan(dt: np.dtype, fields: tuple):
    key = (dt, fields)
    ops = _PLANS.get(key)
    if ops is None:
        vals = []
        for f in fields:
            fdt, foff = dt.fields[f][0], dt.fields[f][1]
            vals += [foff, _KIND[(fdt.kind, fdt.itemsize)]]
        ops = (ctypes.c_int64 * len(vals))(*vals)
        _PLANS[key] = ops
    return ops


def _want(a: np.ndarray, dtypes, name: str) -> None:
    if a.dtype not in dtypes:
        raise TypeError(f"column {name} of dtype {a.dtype}; the native "
                        f"decoder writes {' or '.join(map(str, dtypes))}")


_IDS = (np.dtype(np.uint32), np.dtype(np.int64))


# ------------------------------------------------------ columnar kernels
def decode_conn_into(recs: np.ndarray, cols: dict, off: int = 0) -> None:
    """TCP_CONN records → the 16 ConnBatch columns of ``cols`` at lane
    ``off``. The id columns are uint32 (the batch builders) or their
    int64 carrier (the runtime's staging slabs); the values are the
    same."""
    if recs.dtype != wire.TCP_CONN_DT:
        raise TypeError(f"decode_conn_into needs TCP_CONN_DT records, "
                        f"got {recs.dtype}")
    idt = cols["svc_hi"].dtype
    for c in _CONN_ID_COLS:
        _want(cols[c], (idt,) if idt in _IDS else _IDS, c)
    for c in ("bytes_sent", "bytes_rcvd", "duration_us"):
        _want(cols[c], (np.dtype(np.float32),), c)
    _want(cols["host_id"], (np.dtype(np.int32),), "host_id")
    for c in ("is_close", "is_accept"):
        _want(cols[c], (np.dtype(np.bool_), np.dtype(np.uint8)), c)
    for c in _CONN_COLS:
        if len(cols[c]) < off + len(recs):
            raise ValueError(f"column {c} holds {len(cols[c])} lanes, "
                             f"{off + len(recs)} needed")
    L = lib()
    fn = L.gyt_decode_conn if idt == np.uint32 else L.gyt_decode_conn_i64
    recs, rp = _recs_ptr(recs)
    _check(fn(rp, len(recs), *(_ptr(cols[c], off) for c in _CONN_COLS)),
           "gyt_decode_conn")


def decode_resp_into(recs: np.ndarray, svc_hi, svc_lo, resp_us, host_id,
                     off: int = 0) -> None:
    """RESP_SAMPLE records → flat columns at lane ``off`` (ids uint32
    or their int64 carrier)."""
    if recs.dtype != wire.RESP_SAMPLE_DT:
        raise TypeError(f"decode_resp_into needs RESP_SAMPLE_DT records, "
                        f"got {recs.dtype}")
    idt = svc_hi.dtype
    _want(svc_hi, _IDS, "svc_hi")
    _want(svc_lo, (idt,), "svc_lo")
    _want(resp_us, (np.dtype(np.float32),), "resp_us")
    _want(host_id, (np.dtype(np.int32),), "host_id")
    for a in (svc_hi, svc_lo, resp_us, host_id):
        if len(a) < off + len(recs):
            raise ValueError(f"a resp column holds {len(a)} lanes, "
                             f"{off + len(recs)} needed")
    L = lib()
    fn = L.gyt_decode_resp if idt == np.uint32 else L.gyt_decode_resp_i64
    recs, rp = _recs_ptr(recs)
    _check(fn(rp, len(recs), _ptr(svc_hi, off), _ptr(svc_lo, off),
              _ptr(resp_us, off), _ptr(host_id, off)), "gyt_decode_resp")


def split_u64_into(recs: np.ndarray, field: str, hi, lo,
                   off: int = 0) -> None:
    """One u64 record field → (hi, lo) uint32 columns at lane ``off``."""
    _want(hi, (np.dtype(np.uint32),), "hi")
    _want(lo, (np.dtype(np.uint32),), "lo")
    recs, rp = _recs_ptr(recs)
    _check(lib().gyt_split_u64(
        rp, len(recs), recs.dtype.itemsize, recs.dtype.fields[field][1],
        _ptr(hi, off), _ptr(lo, off)), "gyt_split_u64")


def pack_f32_into(recs: np.ndarray, fields: tuple, out: np.ndarray,
                  off: int = 0) -> None:
    """Record fields → float32 matrix rows [off:off+n) of ``out``
    (shape (size, len(fields)), C-contiguous)."""
    if not out.flags.c_contiguous or out.dtype != np.float32 \
            or out.shape[1] != len(fields):
        raise ValueError(f"pack_f32_into needs a C-contiguous float32 "
                         f"(size, {len(fields)}) output, got "
                         f"{out.dtype}{out.shape}")
    recs, rp = _recs_ptr(recs)
    _check(lib().gyt_pack_f32(
        rp, len(recs), recs.dtype.itemsize, _plan(recs.dtype, fields),
        len(fields), _ptr(out, off)), "gyt_pack_f32")


def pack_i32_into(recs: np.ndarray, field: str, out, off: int = 0) -> None:
    """One scalar record field → int32 column at lane ``off``."""
    _want(out, (np.dtype(np.int32),), field)
    fdt = recs.dtype.fields[field][0]
    recs, rp = _recs_ptr(recs)
    _check(lib().gyt_pack_i32(
        rp, len(recs), recs.dtype.itemsize, recs.dtype.fields[field][1],
        _KIND[(fdt.kind, fdt.itemsize)], _ptr(out, off)), "gyt_pack_i32")


# ------------------------------------------------------------- deframe
def drain2(buf: bytes) -> tuple[dict, int, int]:
    """byte stream → ({subtype: record array}, consumed, unknown_recs),
    the semantics of ``wire.drain2``: a sizing scan, then one frame
    walk appending every subtype's records into its preallocated array.
    Validation errors raise ``wire.FrameError`` with the Python
    decoder's ``reason``."""
    L = lib()
    n = len(_SCAN_ORDER)
    counts = (ctypes.c_int64 * n)()
    consumed = ctypes.c_int64()
    unknown = ctypes.c_int64()
    rc = L.gyt_scan2(buf, len(buf), counts, ctypes.byref(consumed),
                     ctypes.byref(unknown))
    if rc != 0:
        raise wire.FrameError(f"native scan: {_ERRNAMES.get(rc, rc)}",
                              reason=_ERRREASON.get(rc, "bad_frame"))
    out: dict = {}
    outs = (ctypes.c_void_p * n)()
    caps = (ctypes.c_int64 * n)()
    nrec = (ctypes.c_int64 * n)()
    for i, subtype in enumerate(_SCAN_ORDER):
        if counts[i]:
            rec = np.empty(counts[i], wire.DTYPE_OF_SUBTYPE[subtype])
            out[subtype] = rec
            outs[i] = rec.ctypes.data
            caps[i] = rec.nbytes
    if not out:
        return out, int(consumed.value), int(unknown.value)
    c2 = ctypes.c_int64()
    rc = L.gyt_extract_multi(buf, len(buf), outs, caps, nrec,
                             ctypes.byref(c2))
    if rc != 0:
        raise wire.FrameError(f"native extract: {_ERRNAMES.get(rc, rc)}",
                              reason=_ERRREASON.get(rc, "bad_frame"))
    for i, subtype in enumerate(_SCAN_ORDER):
        if counts[i] and nrec[i] != counts[i]:
            raise RuntimeError(f"native extract of subtype {subtype}: "
                               f"{nrec[i]} of {counts[i]} records")
    return out, int(consumed.value), int(unknown.value)
