"""The port's segment shipper and receiver, and the remote compaction
region, against the reference's.

The reference's ten protocol cases (``tests/test_segship.py``) on the
port's ``SegmentShipper`` and ``SegmentReceiver``: bit-identical
landing with the ledger and the ship floor, resume after a mid-segment
disconnect, wire corruption rejected then re-shipped, a receiver
restart sweeping partials and re-deriving its counters from the ledger,
staging-bound sheds, source sheds through ``pin_bytes``, epochs, owner
binding and the staging sweep, ``compact list`` provenance, the floor
pinning truncation, and ``seg_info`` against the receiver's hash —
with the global invariant ``sealed == shipped + counted drops`` held
throughout. The sharded layout ships in offline dir mode from a
``shard_NN/`` root of flat journals, and from the sharded runtime's
live ``ShardedJournal``.

Across packages, in both directions (reference shipper → port receiver,
port shipper → reference receiver), each layout lands the same bytes as
the reference's own pair, and the ledgers are equal modulo the fields
that carry time, pid, instance token and host (:data:`VOLATILE`).

The remote region on the CPU: a port ``Runtime(device="cpu")`` with a
journal runs four ticks at ``tests/test_torch_history.py``'s geometry;
its sealed WAL ships, and ``_StagingCompactLoop(device="cpu")`` compacts
the staging dir. The region's shards equal a local ``Compactor``'s over
the same WAL, 114/114 leaves bit for bit, and the ``at=``/``window=``
JSON served from either store is equal. A ``shard_NN/`` staging dir of
a 2-shard runtime compacts to the same shards as a local compactor over
its WAL. No reference ``Runtime`` is started: the reference's shipper
and receiver import no JAX.
"""

import asyncio
import json
import socket
import threading

import pytest

from gyeeta_tpu.history import shipper as j_ship
from gyeeta_tpu.net import segship as j_seg
from gyeeta_tpu.utils.selfstats import Stats as JStats
from gyeeta_tpu_torch import cli as t_cli
from gyeeta_tpu_torch.engine.aggstate import EngineCfg as TCfg
from gyeeta_tpu_torch.history import shipper as t_ship
from gyeeta_tpu_torch.history.compactor import Compactor as TCompactor
from gyeeta_tpu_torch.history.shipper import SegmentShipper, seg_info
from gyeeta_tpu_torch.ingest import wire as t_wire
from gyeeta_tpu_torch.net import segship as SP
from gyeeta_tpu_torch.net.segship import LEDGER_NAME, SegmentReceiver
from gyeeta_tpu_torch.runtime import Runtime as TRuntime
from gyeeta_tpu_torch.server_main import _StagingCompactLoop
from gyeeta_tpu_torch.sim import ParthaSim as TSim
from gyeeta_tpu_torch.utils import journal as J
from gyeeta_tpu_torch.utils.config import RuntimeOpts as TOpts
from gyeeta_tpu_torch.utils.selfstats import Stats
from test_torch_history import GEOM, OPTS, T0, TICK_SECONDS, tick_buffers
from test_torch_runtime import assert_json_equal

TIMEOUT = 30.0                  # every wait, seconds
PKG = {"port": (SegmentReceiver, SegmentShipper, Stats),
       "ref": (j_seg.SegmentReceiver, j_ship.SegmentShipper, JStats)}
# ledger fields that carry time, pid, instance token and host: the only
# ones two runs of the same segments may differ in
VOLATILE = ("t_usec", "src.pid", "src.token", "src.host")


@pytest.fixture(autouse=True)
def no_dns(monkeypatch):
    """A lookup off the box is refused while a test runs."""
    def refuse(*_a, **_k):
        raise OSError("no dns")
    monkeypatch.setattr(socket, "getnameinfo", refuse)


def _mk_flat(path, nrec=200, blob=512, seg_bytes=1 << 16):
    j = J.Journal(path, segment_max_bytes=seg_bytes, fsync_bytes=1 << 30)
    for i in range(nrec):
        j.append(b"y" * blob, hid=i % 3, conn_id=i, tick=i // 10)
    j.seal_active()
    j.fsync()
    return j


def _mk_sharded(path, n=2, nrec=2000, blob=100):
    """A sharded WAL root (``shard_NN/``, one flat journal each, a
    chunk placed by its host), closed: offline dir mode ships it."""
    js = [J.Journal(path / f"shard_{s:02d}", segment_max_bytes=1 << 16,
                    fsync_bytes=1 << 30) for s in range(n)]
    for i in range(nrec):
        js[(i % 5) % n].append(b"x" * blob, hid=i % 5, conn_id=i,
                               tick=i // 20)
    for j in js:
        j.seal_active()
        j.close()
    return [len(J.dir_segments(path / f"shard_{s:02d}"))
            for s in range(n)]


def _run_pair(staging, *, journal=None, wal_dir=None, rstats=None,
              sstats=None, renv=None, prep=None, cfg_extra=None,
              shipper_id="s1", recv="port", ship="port"):
    """One receiver + one once-mode shipper to completion; returns
    (receiver, shipper) with both stopped."""
    Recv, Ship, St = PKG[recv][0], PKG[ship][1], PKG[ship][2]
    rstats = rstats if rstats is not None else PKG[recv][2]()
    sstats = sstats if sstats is not None else St()

    async def go():
        rcv = Recv(staging, stats=rstats, host="127.0.0.1",
                   env={} if renv is None else renv)
        h, p = await asyncio.wait_for(rcv.start(), TIMEOUT)
        t = sh = None
        try:
            cfg = {"target": (h, p), "shipper_id": shipper_id,
                   "stats": sstats, "scan_s": 0.05, "hb_s": 0.05,
                   "once": True}
            if journal is not None:
                cfg["journal"] = journal
            else:
                cfg["dir"] = wal_dir
            cfg.update(cfg_extra or {})
            sh = Ship(cfg)
            if prep:
                prep(sh)
            t = threading.Thread(target=sh.run, daemon=True)
            t.start()

            async def done():
                while t.is_alive():
                    await asyncio.sleep(0.02)
            await asyncio.wait_for(done(), TIMEOUT)
        finally:
            if sh is not None:
                sh.stop()
            if t is not None:
                t.join(timeout=5.0)
            await asyncio.wait_for(rcv.stop(), TIMEOUT)
        assert not t.is_alive(), "shipper did not finish"
        return rcv, sh

    return asyncio.run(go())


def _landed_identical(src_dir, staging, shards, upto):
    for s in range(shards):
        sd = src_dir / f"shard_{s:02d}" if shards > 1 else src_dir
        dd = staging / f"shard_{s:02d}" if shards > 1 else staging
        for q in J.dir_segments(sd):
            if q >= upto[s]:
                continue
            a = (sd / J._SEG_FMT.format(q)).read_bytes()
            b = (dd / J._SEG_FMT.format(q)).read_bytes()
            assert a == b, (s, q)


def _ledger(staging):
    return [json.loads(ln) for ln in
            (staging / LEDGER_NAME).read_bytes().splitlines()]


# ------------------------------------------------------ the ten cases
@pytest.mark.parametrize("layout", ["flat_live", "sharded_dir"])
def test_ship_bit_identical_ledger_and_floor(tmp_path, layout):
    rstats, sstats = Stats(), Stats()
    if layout == "flat_live":
        j = _mk_flat(tmp_path / "wal", nrec=2000, blob=100)
        upto = [j.sealed_upto()]
        try:
            _run_pair(tmp_path / "stage", journal=j, rstats=rstats,
                      sstats=sstats)
            # nothing pending → the ship floor releases truncation up
            # to the sealed bound
            assert j._floors["ship"] == upto[0]
        finally:
            j.close()
    else:
        upto = _mk_sharded(tmp_path / "wal")
        _run_pair(tmp_path / "stage", wal_dir=tmp_path / "wal",
                  rstats=rstats, sstats=sstats)
    want = sum(upto)
    assert want >= 3
    _landed_identical(tmp_path / "wal", tmp_path / "stage", len(upto),
                      upto)
    # global ledger closes exactly: sealed == shipped + dropped
    c = rstats.snapshot()
    assert c["ship_shipped_segments"] == want
    assert c.get("ship_dropped_segments", 0) == 0
    assert c["ship_sealed_segments|shipper=s1"] == want
    assert c["ship_shipped_records"] == 2000
    sc = sstats.snapshot()
    assert sc["ship_shipped_segments"] == want
    assert sc["ship_sealed_records"] == 2000
    entries = _ledger(tmp_path / "stage")
    owner = [e for e in entries if e.get("meta") == "owner"]
    assert owner and owner[0]["layout"] == \
        ("flat" if layout == "flat_live" else "sharded")
    landed = [e for e in entries if e.get("status") == "landed"]
    assert len(landed) == want
    for e in landed:
        assert len(e["hash"]) == 64
        assert e["src"]["shipper"] == "s1"
        assert e["src"]["token"]


def test_ship_resume_after_mid_segment_disconnect(tmp_path):
    j = _mk_flat(tmp_path / "wal")
    upto = j.sealed_upto()
    assert upto >= 2
    rstats, sstats = Stats(), Stats()

    def prep(sh):
        orig = sh._send
        state = {"n": 0, "tripped": False}

        def tripping(buf):
            ftype = SP._FH.unpack_from(buf, 0)[1]
            if ftype == SP.T_SDATA and not state["tripped"]:
                state["n"] += 1
                if state["n"] >= 3:
                    # cut the uplink mid-segment: the partial stays on
                    # the receiver; the reconnect resumes at its offset
                    state["tripped"] = True
                    sh._sock.close()
                    raise ConnectionError("injected mid-segment cut")
            orig(buf)

        sh._send = tripping

    try:
        _run_pair(tmp_path / "stage", journal=j, rstats=rstats,
                  sstats=sstats, cfg_extra={"chunk_bytes": 4096},
                  prep=prep)
    finally:
        j.close()
    _landed_identical(tmp_path / "wal", tmp_path / "stage", 1, [upto])
    c = rstats.snapshot()
    assert c["ship_shipped_segments"] == upto
    assert c["ship_resumes"] >= 1
    assert c["ship_reconnects|shipper=s1"] >= 1     # same-token resume
    assert c.get("ship_epochs|shipper=s1", 0) == 0  # NOT an epoch
    assert sstats.snapshot()["ship_resumed_bytes"] > 0


def test_wire_corruption_rejected_then_reshipped(tmp_path):
    j = _mk_flat(tmp_path / "wal")
    upto = j.sealed_upto()
    rstats, sstats = Stats(), Stats()

    def prep(sh):
        orig = sh._send
        state = {"done": False}

        def corrupting(buf):
            ftype = SP._FH.unpack_from(buf, 0)[1]
            if ftype == SP.T_SDATA and not state["done"]:
                state["done"] = True
                i = SP._FH.size
                buf = buf[:i] + bytes([buf[i] ^ 0xFF]) + buf[i + 1:]
            orig(buf)

        sh._send = corrupting

    try:
        _run_pair(tmp_path / "stage", journal=j, rstats=rstats,
                  sstats=sstats, prep=prep)
    finally:
        j.close()
    # the corrupted transfer was discarded (never visible to the
    # compactor), counted, and the re-ship landed the true bytes
    _landed_identical(tmp_path / "wal", tmp_path / "stage", 1, [upto])
    c = rstats.snapshot()
    assert c["ship_hash_mismatches"] >= 1
    assert c["ship_shipped_segments"] == upto
    assert sstats.snapshot()["ship_hash_retries"] >= 1


def test_receiver_restart_sweeps_partials_rederives_ledger(tmp_path):
    want = sum(_mk_sharded(tmp_path / "wal"))
    r1 = Stats()
    _run_pair(tmp_path / "stage", wal_dir=tmp_path / "wal", rstats=r1)
    assert r1.snapshot()["ship_shipped_segments"] == want
    # a torn receiver-side partial left by a crash...
    stray = tmp_path / "stage" / "shard_00" / SP._PART_FMT.format(999)
    stray.write_bytes(b"torn")
    # ...restart: partial swept (counted), global counters re-derived
    # from the ledger alone, and a fresh shipper run (new token — a
    # true restart) answers "done" for every key without re-landing
    r2 = Stats()
    _run_pair(tmp_path / "stage", wal_dir=tmp_path / "wal", rstats=r2)
    assert not stray.exists()
    c = r2.snapshot()
    assert c["ship_partials_swept"] == 1
    assert c["ship_shipped_segments"] == want       # ledger-derived
    assert c["ship_shipped_records"] == 2000
    assert c.get("ship_hash_mismatches", 0) == 0    # nothing re-sent


def test_staging_bound_sheds_are_counted(tmp_path):
    # two ~700KB sealed segments against a 1MB staging bound: the
    # first lands, the second is SHED — terminal, counted, in the
    # ledger — and the global invariant still closes
    j = _mk_flat(tmp_path / "wal", nrec=44, blob=1 << 15,
                 seg_bytes=700 * 1024)
    upto = j.sealed_upto()
    assert upto >= 2
    rstats = Stats()
    try:
        _run_pair(tmp_path / "stage", journal=j, rstats=rstats,
                  renv={"GYT_SHIP_STAGE_MB": "1"})
    finally:
        j.close()
    c = rstats.snapshot()
    assert c["ship_stage_sheds"] >= 1
    assert c["ship_dropped_segments"] == c["ship_stage_sheds"]
    assert (c["ship_shipped_segments"] + c["ship_dropped_segments"]
            == upto == c["ship_sealed_segments|shipper=s1"])
    entries = [e for e in _ledger(tmp_path / "stage") if "k" in e]
    assert any(e["status"] == "shed" for e in entries)


def test_source_shed_announces_counted_drops(tmp_path):
    # a receiver outage longer than the pin bound: the shipper sheds
    # its oldest unshipped segments as announced permanent T_SDROPs —
    # counted at both ends, never silence
    _mk_flat(tmp_path / "wal").close()
    nsegs = len(J.dir_segments(tmp_path / "wal"))
    rstats, sstats = Stats(), Stats()
    _run_pair(tmp_path / "stage", wal_dir=tmp_path / "wal",
              rstats=rstats, sstats=sstats, cfg_extra={"pin_bytes": 1},
              prep=lambda sh: setattr(sh, "_ship_one",
                                      lambda s, q, p: False))
    c = rstats.snapshot()
    assert c["ship_dropped_segments"] == nsegs
    assert c.get("ship_shipped_segments", 0) == 0
    assert sstats.snapshot()["ship_dropped_segments"] == nsegs
    entries = [e for e in _ledger(tmp_path / "stage") if "k" in e]
    assert all(e["reason"] == "source_shed" for e in entries)
    # the pin bound also comes in through the env mapping
    assert t_ship.pin_max_bytes({"GYT_SHIP_PIN_MB": "3"}) == 3 << 20
    assert t_ship.pin_max_bytes() == 0


def test_epoch_bump_owner_binding_and_staging_sweep(tmp_path):
    upto = _mk_sharded(tmp_path / "wal")
    want = sum(upto)
    rstats = Stats()

    async def go():
        rcv = SegmentReceiver(tmp_path / "stage", stats=rstats,
                              host="127.0.0.1")
        h, p = await asyncio.wait_for(rcv.start(), TIMEOUT)

        async def ship(sid):
            sh = SegmentShipper({"target": (h, p), "shipper_id": sid,
                                 "dir": tmp_path / "wal",
                                 "stats": Stats(), "scan_s": 0.05,
                                 "once": True})
            t = threading.Thread(target=sh.ship_once, daemon=True)
            t.start()

            async def done():
                while t.is_alive():
                    await asyncio.sleep(0.02)
            await asyncio.wait_for(done(), TIMEOUT)
            t.join(5.0)

        try:
            await ship("s1")
            # run 2, SAME id, NEW token = a restarted shipper process:
            # epoch boundary, every key answers "done" from the ledger
            await ship("s1")
            c = rstats.snapshot()
            assert c["ship_epochs|shipper=s1"] == 1
            assert c["ship_shipped_segments"] == want   # no double-land
            # a DIFFERENT shipper id is refused: one source region owns
            # a staging dir (shard/seq must stay collision-free)
            sh3 = SegmentShipper({"target": (h, p), "shipper_id": "other",
                                  "dir": tmp_path / "wal",
                                  "stats": Stats()})
            ok = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, sh3._connect), TIMEOUT)
            assert not ok
            assert rstats.snapshot()["ship_hello_refused"] >= 1
            # compaction-floor sweep reclaims landed staging, the
            # ledger keeps answering "done" for swept keys
            assert rcv.sweep_below(list(upto)) == want
            assert rstats.snapshot()["ship_staged_swept"] == want
            await ship("s1")
            assert rstats.snapshot()["ship_shipped_segments"] == want
        finally:
            await asyncio.wait_for(rcv.stop(), TIMEOUT)

    asyncio.run(go())


def test_compact_list_renders_ship_provenance(tmp_path, capsys):
    want = sum(_mk_sharded(tmp_path / "wal"))
    _run_pair(tmp_path / "stage", wal_dir=tmp_path / "wal")
    (tmp_path / "parts").mkdir()
    t_cli.main(["compact", "list", "--shard-dir", str(tmp_path / "parts"),
                "--journal-dir", str(tmp_path / "stage")])
    out = json.loads(capsys.readouterr().out)
    assert out["shards"] == [] and out["pos"] is None
    segs = out["shipped_segments"]
    assert len(segs) == want
    for e in segs:
        assert e["status"] == "landed"
        assert len(e["hash"]) == 64
        assert e["src_shipper"] == "s1"
        assert e["src_epoch"] == 0
        assert e["segment"].count("/") == 1


def test_floor_pins_source_truncation_until_landed(tmp_path):
    # end-to-end floor contract: before shipping, the ship floor pins
    # checkpoint truncation at 0; after landing, truncation releases
    j = _mk_flat(tmp_path / "wal")
    try:
        upto = j.sealed_upto()
        newest = j.position()[0]
        # a shipper that CANNOT reach its receiver still registers the
        # floor from its scan loop (no uplink required to pin)
        sh = SegmentShipper({"target": ("127.0.0.1", 1), "journal": j,
                             "shipper_id": "s1", "stats": Stats()})
        sh._advance_floor()
        j.set_truncate_floor(newest, name="compact")
        assert j.truncate_upto(newest) == 0             # all pinned
        assert set(J.dir_segments(tmp_path / "wal")) >= set(range(upto))
        rstats = Stats()
        _run_pair(tmp_path / "stage", journal=j, rstats=rstats)
        assert rstats.snapshot()["ship_shipped_segments"] == upto
        assert j.truncate_upto(newest) == upto          # released
    finally:
        j.close()


def test_seg_info_matches_receiver_hash(tmp_path):
    _mk_flat(tmp_path / "wal", nrec=10).close()
    segs = J.dir_segments(tmp_path / "wal")
    p = tmp_path / "wal" / J._SEG_FMT.format(segs[0])
    size, digest, nrec = seg_info(p)
    assert size == p.stat().st_size
    assert digest == SP.seg_hash(p) == j_seg.seg_hash(p)
    assert nrec == 10
    assert (size, digest, nrec) == j_ship.seg_info(p)


def test_knob_readers_take_an_env_mapping():
    """Each knob reads the mapping it is given with the reference's
    default; without one it reads no environment."""
    env = {"GYT_SHIP_HB_S": "0.3", "GYT_SHIP_HB_STALE_S": "7",
           "GYT_SHIP_CHUNK_KB": "64", "GYT_SHIP_STAGE_MB": "2"}
    for f in ("hb_interval_s", "hb_stale_s", "chunk_bytes",
              "stage_max_bytes"):
        assert getattr(SP, f)(env) == getattr(j_seg, f)(env)
        assert getattr(SP, f)() == getattr(j_seg, f)({})
    sh = SegmentShipper({"target": ("127.0.0.1", 1), "dir": "x",
                         "env": {"GYT_SHIP_SCAN_S": "2",
                                 "GYT_SHIP_CHUNK_KB": "8"}})
    assert (sh.scan_s, sh.chunk, sh.pin_max) == (2.0, 8192, 0)


# ---------------------------------------------------- across packages
def _strip(e):
    e = dict(e)
    src = dict(e.pop("src", None) or {})
    for f in VOLATILE:
        if f.startswith("src."):
            src.pop(f[4:], None)
        else:
            e.pop(f, None)
    if src:
        e["src"] = src
    return e


def _staged(staging):
    return {str(p.relative_to(staging)): p.read_bytes()
            for p in sorted(staging.rglob("*.gytwal"))}


_STABLE = ("ship_shipped_segments", "ship_shipped_records",
           "ship_shipped_bytes", "ship_sealed_segments|shipper=s1",
           "ship_src_sealed_records|shipper=s1",
           "ship_src_sealed_bytes|shipper=s1")


@pytest.mark.parametrize("layout", ["flat", "sharded"])
@pytest.mark.parametrize("ship,recv", [("ref", "port"), ("port", "ref")],
                         ids=["ref_to_port", "port_to_ref"])
def test_cross_package_landing_equals_reference_pair(tmp_path, layout,
                                                     ship, recv):
    if layout == "flat":
        _mk_flat(tmp_path / "wal").close()
    else:
        _mk_sharded(tmp_path / "wal", nrec=600)
    got, ref = {}, {}
    for tag, (s, r) in (("ref", ("ref", "ref")), ("got", (ship, recv))):
        stats = PKG[r][2]()
        _run_pair(tmp_path / tag, wal_dir=tmp_path / "wal", rstats=stats,
                  ship=s, recv=r)
        out = got if tag == "got" else ref
        out["staged"] = _staged(tmp_path / tag)
        out["ledger"] = [_strip(e) for e in _ledger(tmp_path / tag)]
        snap = stats.snapshot()
        out["ctr"] = {k: snap.get(k) for k in _STABLE}
    assert ref["staged"] and got["staged"] == ref["staged"]
    assert got["ledger"] == ref["ledger"]
    assert got["ctr"] == ref["ctr"]
    assert ref["ctr"]["ship_shipped_segments"] == len(ref["staged"])


# ------------------------------------------- the remote region, on the CPU
def _run_source(tmp):
    """Four ticks of the history tests' stream through a port runtime
    with a journal, then the next tick's bytes (the evidence that
    closes the window at tick 4); the WAL is sealed."""
    now = [T0]
    opts = TOpts(**OPTS, journal_dir=str(tmp / "wal"))
    rt = TRuntime(TCfg(**GEOM), opts, clock=lambda: now[0], device="cpu")
    names, bufs = tick_buffers(TSim, t_wire)
    rt.feed(names)
    for buf in bufs:
        rt.feed(buf, hid=3, conn_id=11)
        now[0] += TICK_SECONDS
        rt.run_tick()
    rt.feed(bufs[0], hid=3, conn_id=11)
    rt.flush()
    rt.journal.seal_active()
    rt.journal.fsync()
    return rt, opts


def _serve(shard_dir, reqs):
    rt = TRuntime(TCfg(**GEOM), TOpts(**OPTS, hist_shard_dir=str(shard_dir)),
                  clock=lambda: T0 + 100.0, device="cpu")
    try:
        rt.feed(tick_buffers(TSim, t_wire)[0])
        return {k: rt.query(dict(r)) for k, r in reqs.items()}
    finally:
        rt.close()


REGION_REQS = {
    "svcstate_at": {"subsys": "svcstate", "at": "tick:4", "maxrecs": 100},
    "topk_at": {"subsys": "topk", "at": "tick:2", "maxrecs": 50},
    "flowstate_at": {"subsys": "flowstate", "at": "tick:4",
                     "maxrecs": 200},
    "svcstate_window": {"subsys": "svcstate", "window": "1h",
                        "maxrecs": 100},
    "hoststate_window": {"subsys": "hoststate", "window": "1h"},
}


def test_remote_region_equals_local_compaction(tmp_path):
    src, opts = _run_source(tmp_path)
    loop = local = None
    try:
        upto = src.journal.sealed_upto()
        rstats = Stats()
        _run_pair(tmp_path / "stage", journal=src.journal, rstats=rstats)
        assert src.journal._floors["ship"] == upto
        assert rstats.snapshot()["ship_shipped_segments"] == upto
        _landed_identical(tmp_path / "wal", tmp_path / "stage", 1, [upto])
        hopts = opts._replace(journal_dir=None)
        loop = _StagingCompactLoop(src.cfg, hopts, str(tmp_path / "stage"),
                                   str(tmp_path / "region"), stats=Stats(),
                                   device="cpu")
        loop.pass_once()
        assert loop.compactor._rt.device.type == "cpu"
        local = TCompactor(src.cfg, hopts, journal_dir=str(tmp_path / "wal"),
                           shard_dir=str(tmp_path / "local"), device="cpu")
        local.compact_once()
        rs, ls = loop.compactor.store, local.store
        assert [e["tick1"] for e in rs.shards("raw")] == \
            [e["tick1"] for e in ls.shards("raw")] == [2, 4]
        assert rs.position() == ls.position()
        # the compacted floor sweeps the landed staging it covers
        assert loop.floors() == J.floors_of(rs.position())
        for ent_r, ent_l in zip(rs.shards("raw"), ls.shards("raw")):
            got, want = rs.load(ent_r), ls.load(ent_l)
            leaves = [(a, b) for part in ("state", "dep")
                      for a, b in zip(got[part], want[part])]
            assert len(leaves) == 114
            for i, (a, b) in enumerate(leaves):
                assert a.dtype == b.dtype and a.shape == b.shape, i
                assert a.tobytes() == b.tobytes(), i
    finally:
        if loop is not None:
            loop.final_pass()
        if local is not None:
            local.close()
        src.close()
    got = _serve(tmp_path / "region", REGION_REQS)
    want = _serve(tmp_path / "local", REGION_REQS)
    for k in REGION_REQS:
        assert got[k]["recs"], k
        assert_json_equal(want[k], got[k])


def test_sharded_staging_refused_naming_item_6(tmp_path):
    """No longer refused since the sharded runtime is ported: a 2-shard
    runtime's live per-shard WAL (``shard_NN/``) ships, lands byte for
    byte, and the staging loop replays it with the compactor's
    tick-merged walk into shards equal, leaf for leaf, to a local
    ``Compactor``'s over the same WAL, with per-shard positions."""
    from gyeeta_tpu_torch.parallel.mesh import make_mesh
    from gyeeta_tpu_torch.parallel.shardedrt import ShardedRuntime
    now = [T0]
    opts = TOpts(**OPTS, journal_dir=str(tmp_path / "wal"))
    src = ShardedRuntime(TCfg(**GEOM), make_mesh(2, device="cpu"), opts,
                         clock=lambda: now[0])
    loop = local = None
    try:
        names, bufs = tick_buffers(TSim, t_wire)
        src.feed(names)
        for i, buf in enumerate(bufs):
            src.feed(buf, hid=i % 2, conn_id=11)
            now[0] += TICK_SECONDS
            src.run_tick()
        src.feed(bufs[0], hid=0, conn_id=11)
        src.feed(bufs[1], hid=1, conn_id=12)
        src.flush()
        src.journal.seal_active()
        src.journal.fsync()
        upto = src.journal.sealed_upto()
        assert len(upto) == 2 and min(upto) >= 1
        _run_pair(tmp_path / "stage", journal=src.journal)
        _landed_identical(tmp_path / "wal", tmp_path / "stage", 2, upto)
        hopts = opts._replace(journal_dir=None)
        loop = _StagingCompactLoop(src.cfg, hopts, str(tmp_path / "stage"),
                                   str(tmp_path / "region"),
                                   stats=Stats(), device="cpu")
        loop.pass_once()
        local = TCompactor(src.cfg, hopts, journal_dir=str(tmp_path / "wal"),
                           shard_dir=str(tmp_path / "local"), device="cpu")
        local.compact_once()
        rs, ls = loop.compactor.store, local.store
        assert [e["tick1"] for e in rs.shards("raw")] == \
            [e["tick1"] for e in ls.shards("raw")] == [2, 4]
        assert rs.position() == ls.position()
        assert [p[0] for p in rs.position()] == [0, 1]   # per shard
        assert loop.floors() == J.floors_of(rs.position())
        for ent_r, ent_l in zip(rs.shards("raw"), ls.shards("raw")):
            got, want = rs.load(ent_r), ls.load(ent_l)
            leaves = [(a, b) for part in ("state", "dep")
                      for a, b in zip(got[part], want[part])]
            assert len(leaves) == 114
            for i, (a, b) in enumerate(leaves):
                assert a.dtype == b.dtype and a.shape == b.shape, i
                assert a.tobytes() == b.tobytes(), i
    finally:
        if loop is not None:
            loop.final_pass()
        if local is not None:
            local.close()
        src.close()


def test_staging_loop_waits_for_segments_and_runs_on_its_device(tmp_path):
    """An empty staging dir builds nothing; the loop's replay runtime
    takes the daemon's device, which is CUDA unless the CPU is asked
    for (and raises without a GPU)."""
    import torch
    (tmp_path / "stage").mkdir()
    loop = _StagingCompactLoop(TCfg(**GEOM), TOpts(**OPTS),
                               str(tmp_path / "stage"),
                               str(tmp_path / "region"))
    loop.pass_once()
    assert loop.compactor is None and loop.floors() is None
    _mk_flat(tmp_path / "stage", nrec=4).close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loop.pass_once()
    loop.final_pass()
