"""The port's shared-memory staging ring (``gyeeta_tpu_torch/utils/
shmring.py``): the reference's tests of ``tests/test_shmring.py`` on the
port's module, plus the cross-package cases — a ring the reference's
producer writes drains through the port's consumer, and the reverse,
with the same records, counters and drop ledger.

Covers the concurrency contract pure-functionally (one process, both
roles on one segment — the cross-process halves are exercised by the
ingest-worker e2e in test_ingestproc.py): commit-then-head publication,
drop-oldest with RECORD-exact accounting recovered from the per-shard
cum chain, producer resume after a simulated worker crash, and the
section pack/split/unpack round trip over real wire dtypes."""

import numpy as np
import pytest

from gyeeta_tpu.utils import shmring as j_shmring
from gyeeta_tpu_torch.ingest import wire
from gyeeta_tpu_torch.utils import shmring


@pytest.fixture
def seg():
    import uuid
    s = shmring.WorkerShm(f"gyt_t_test_ring_{uuid.uuid4().hex[:8]}",
                          nshards=2, slots=8, slot_bytes=4096,
                          create=True)
    yield s
    s.close()
    s.unlink()


def _conn_recs(n, hid=0):
    r = np.zeros(n, wire.TCP_CONN_DT)
    r["host_id"] = hid
    r["bytes_sent"] = np.arange(n)
    return r


def test_pack_unpack_roundtrip():
    recs = {wire.NOTIFY_TCP_CONN: _conn_recs(5),
            wire.NOTIFY_RESP_SAMPLE: np.zeros(3, wire.RESP_SAMPLE_DT)}
    buf = shmring.pack_sections(recs)
    out, n = shmring.unpack_sections(buf, wire.DTYPE_OF_SUBTYPE)
    assert n == 8
    assert set(out) == set(recs)
    np.testing.assert_array_equal(out[wire.NOTIFY_TCP_CONN],
                                  recs[wire.NOTIFY_TCP_CONN])


def test_unpack_skips_unknown_subtype():
    buf = shmring.pack_sections({wire.NOTIFY_TCP_CONN: _conn_recs(2)})
    out, n = shmring.unpack_sections(buf, {})
    assert out == {} and n == 0


def test_split_records_respects_slot_budget():
    recs = {wire.NOTIFY_TCP_CONN: _conn_recs(100)}
    pieces = list(shmring.split_records(recs, max_payload=4096))
    assert len(pieces) > 1                     # forced multiple slots
    total = 0
    for payload, nrec in pieces:
        assert len(payload) <= 4096
        out, n = shmring.unpack_sections(payload,
                                         wire.DTYPE_OF_SUBTYPE)
        assert n == nrec
        total += n
    assert total == 100


def test_split_records_oversized_record_raises():
    # a record wider than the slot payload must fail LOUD: silently
    # `continue`-ing here used to spin forever and wedge the worker
    wide = np.zeros(2, dtype=[("blob", "V512")])
    with pytest.raises(ValueError, match="itemsize"):
        list(shmring.split_records({9999: wide}, max_payload=256))


def test_publish_drain_roundtrip(seg):
    recs = {wire.NOTIFY_TCP_CONN: _conn_recs(4, hid=3)}
    payload = shmring.pack_sections(recs)
    seg.publish(1, payload, 4)
    bufs, nrec, ds, dr = seg.drain(1)
    assert (nrec, ds, dr) == (4, 0, 0)
    out, n = shmring.unpack_sections(bufs[0], wire.DTYPE_OF_SUBTYPE)
    assert n == 4
    assert int(out[wire.NOTIFY_TCP_CONN]["host_id"][0]) == 3
    # the other ring saw nothing
    assert seg.drain(0) == ([], 0, 0, 0)
    assert seg.counter("published_records") == 4


def test_drop_oldest_counted_in_records(seg):
    # 8-slot ring: publish 13 slots of 2 records without draining —
    # the first 5 slots are lapped; the drain must recover EXACTLY 10
    # dropped records from the cum chain (counted, never silent)
    for i in range(13):
        seg.publish(0, shmring.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=i)}), 2)
    bufs, nrec, ds, dr = seg.drain(0)
    assert ds == 5 and dr == 10
    assert nrec == 16 and len(bufs) == 8
    # ledger closes: published == consumed + dropped
    assert seg.counter("published_records") == nrec + dr
    # and the surviving slots are the NEWEST ones, in order
    hids = []
    for b in bufs:
        out, _ = shmring.unpack_sections(b, wire.DTYPE_OF_SUBTYPE)
        hids.append(int(out[wire.NOTIFY_TCP_CONN]["host_id"][0]))
    assert hids == list(range(5, 13))


def test_mid_drain_second_lap_accumulates_drops(seg):
    # the producer can lap the consumer AGAIN while one drain call is
    # mid-loop (seq-mismatch resync). The first gap's count used to be
    # overwritten (assignment, not accumulation) and the second gap's
    # records — skipped past the call's stale head — were never
    # counted at all, breaking the "published == consumed + dropped,
    # exactly" ledger. Now the gap accumulates and anything left
    # behind the stale head is recovered by the NEXT drain's cum-chain
    # check.
    for i in range(13):                        # lap #1 before draining
        seg.publish(0, shmring.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=i)}), 2)
    orig = seg._slot_off
    calls = {"n": 0}

    def hook(shard, idx):
        calls["n"] += 1
        if calls["n"] == 3:                    # after 2 consumed slots
            for j in range(13, 21):            # lap #2, mid-drain
                seg.publish(0, shmring.pack_sections(
                    {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=j)}), 2)
        return orig(shard, idx)

    seg._slot_off = hook
    try:
        _bufs, nrec1, ds1, dr1 = seg.drain(0)
    finally:
        seg._slot_off = orig
    assert ds1 > 0 and dr1 > 0
    _bufs, nrec2, ds2, dr2 = seg.drain(0)      # picks up lap #2's ring
    assert seg.counter("published_records") == 21 * 2
    # ledger closes exactly across the two calls
    assert nrec1 + dr1 + nrec2 + dr2 == 21 * 2
    assert seg.backlog(0) == 0
    # records parked (unread) in ring 1 must NOT be counted as drops
    # when ring 0 laps — the regression the per-shard cum chain exists
    # to prevent
    seg.publish(1, shmring.pack_sections(
        {wire.NOTIFY_TCP_CONN: _conn_recs(7)}), 7)
    for i in range(10):
        seg.publish(0, shmring.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(1, hid=i)}), 1)
    _bufs, nrec, ds, dr = seg.drain(0)
    assert (nrec, ds, dr) == (8, 2, 2)
    _bufs, nrec, ds, dr = seg.drain(1)
    assert (nrec, ds, dr) == (7, 0, 0)


def test_producer_resume_after_crash(seg):
    # "crash": throw the producer-side object away mid-stream and
    # re-attach by name (what a respawned worker does). The seq/cum
    # chain continues — the consumer sees one continuous ring.
    for i in range(3):
        seg.publish(0, shmring.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=i)}), 2)
    w2 = shmring.WorkerShm(seg.name)           # respawned worker
    try:
        assert w2.heads()[0] == 3
        w2.publish(0, shmring.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=9)}), 2)
        bufs, nrec, ds, dr = seg.drain(0)
        assert (nrec, ds, dr) == (8, 0, 0) and len(bufs) == 4
        assert seg._read_head(0) == 4
        # cum chain continued exactly (no phantom drops on next lap)
        assert w2.counter("published_records") >= 8
    finally:
        w2.close()


def test_heartbeat_and_counters(seg):
    assert seg.hb_age_s() == float("inf")      # never beaten
    seg.heartbeat()
    assert seg.hb_age_s() < 5.0
    assert seg.counter("hb_seq") == 1
    seg.add_counter("accepted_records", 41)
    seg.add_counter("accepted_records", 1)
    assert seg.counters()["accepted_records"] == 42
    assert seg.epoch() == 0
    assert seg.bump_epoch() == 1


def test_oversize_payload_rejected(seg):
    with pytest.raises(ValueError):
        seg.publish(0, b"x" * (seg.slot_payload + 1), 1)


# ------------------------------------------------------- across packages
@pytest.mark.parametrize("producer,consumer", [
    (j_shmring, shmring), (shmring, j_shmring)],
    ids=["reference_to_port", "port_to_reference"])
def test_ring_crosses_packages(producer, consumer):
    """One package creates a segment and publishes (with a lap); the
    other attaches by name and drains: the same records, the same drop
    ledger in records, the same counters and heartbeat words."""
    import uuid
    name = f"gyt_t_xring_{uuid.uuid4().hex[:8]}"
    prod = producer.WorkerShm(name, nshards=2, slots=8, slot_bytes=4096,
                              create=True)
    cons = None
    try:
        prod.heartbeat()
        prod.add_counter("accepted_records", 33)
        for i in range(11):                    # 3 slots lapped
            prod.publish(0, producer.pack_sections(
                {wire.NOTIFY_TCP_CONN: _conn_recs(3, hid=i)}), 3)
        prod.publish(1, producer.pack_sections(
            {wire.NOTIFY_RESP_SAMPLE: np.zeros(5, wire.RESP_SAMPLE_DT)}), 5)
        cons = consumer.WorkerShm(name)
        assert (cons.nshards, cons.slots, cons.slot_payload) \
            == (2, 8, 4096)
        assert cons.counters() == prod.counters()
        assert cons.counter("accepted_records") == 33
        assert cons.hb_age_s() < 60.0
        # a fresh consumer starts at the head: rewind it to the start
        # of the chain, as the creating supervisor's consumer does
        cons._tail = [0, 0]
        cons._consumed_base = [0, 0]
        bufs, nrec, ds, dr = cons.drain(0)
        assert (nrec, ds, dr) == (24, 3, 9)
        hids = []
        for b in bufs:
            out, n = consumer.unpack_sections(b, wire.DTYPE_OF_SUBTYPE)
            assert n == 3
            hids.append(int(out[wire.NOTIFY_TCP_CONN]["host_id"][0]))
        assert hids == list(range(3, 11))
        bufs, nrec, ds, dr = cons.drain(1)
        out, n = consumer.unpack_sections(bufs[0], wire.DTYPE_OF_SUBTYPE)
        assert (nrec, ds, dr, n) == (5, 0, 0, 5)
        assert prod.counter("published_records") == 24 + 9 + 5
        # the attaching side's producer resumes the chain exactly
        cons.publish(0, consumer.pack_sections(
            {wire.NOTIFY_TCP_CONN: _conn_recs(2, hid=99)}), 2)
        assert prod._read_head(0) == 12
        assert cons._cum_shard[0] == 35
    finally:
        if cons is not None:
            cons.close()
        prod.close()
        prod.unlink()


def test_knobs_come_from_the_env_mapping():
    """Ring geometry is read from an explicit mapping; ``None`` means no
    environment (the reference's defaults)."""
    assert shmring.ring_slots() == 64
    assert shmring.ring_slot_bytes() == 128 * 1024
    env = {"GYT_SHM_RING_SLOTS": "16", "GYT_SHM_RING_SLOT_KB": "8"}
    assert shmring.ring_slots(env) == 16
    assert shmring.ring_slot_bytes(env) == 8 * 1024
    assert shmring.ring_slots(env) == j_shmring.ring_slots(env)
    assert shmring.ring_slot_bytes(env) == j_shmring.ring_slot_bytes(env)
