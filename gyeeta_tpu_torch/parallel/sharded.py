"""Sharded engine: one ``AggState`` a shard and the per-shard folds.

Counterpart of ``gyeeta_tpu/parallel/sharded.py``. Each shard owns an
independent ``AggState`` (its own service slab and sketches) for its
slice of the host-id space — a madhava's role. The reference stacks
them into one ``(n_shards, ...)`` pytree and ``shard_map``s each fold;
here the state is a list with shard ``s`` on ``mesh.devices[s]``, and
each function below runs the port's single-device fold of
``engine/step.py`` on every shard in turn, so the kernels need no shard
offset. Batches arrive routed a shard (:func:`shard_batches`), the
folds run with no collective; collectives appear only in the pairing
dispatch (:func:`fold_step_dep_sharded`) and ``rollup.py``.

The reference memoizes compiled builders by mesh geometry to work
around a jaxlib executable-cache bug; the port compiles nothing, so
these are plain functions over the per-shard lists. Stacking into the
reference's ``(n, ...)`` numpy leaves happens only at the edges
(:func:`state_to_numpy` and friends: checkpoints, history shards,
tests).
"""

from __future__ import annotations

import numpy as np
import torch

from gyeeta_tpu_torch.engine import aggstate, step
from gyeeta_tpu_torch.parallel import depgraph as dg
from gyeeta_tpu_torch.parallel import mesh as M
from gyeeta_tpu_torch.parallel.partition import ShardLayout, \
    stack_leaves, unstack_leaves
from gyeeta_tpu_torch.semantic import derive
from gyeeta_tpu_torch.utils.tensor import tree_map


def init_sharded(cfg: aggstate.EngineCfg, mesh) -> list:
    """One fresh ``AggState`` a shard, on its device."""
    return [aggstate.init(cfg, d) for d in mesh.devices]


def dep_init_sharded(mesh, pair_capacity: int, edge_capacity: int) -> list:
    """One empty ``DepGraph`` a shard, on its device."""
    return [dg.init(pair_capacity, edge_capacity, d) for d in mesh.devices]


def stack_prerouted(batch_fns, per_shard_records) -> list:
    """Per-shard host batches from records already routed a shard (the
    ingest edge hashes hosts to shards once, at staging): ``batch_fns``
    is (builder, lanes), e.g. ``(decode.conn_batch, cfg.conn_batch)``."""
    builder, lanes = batch_fns
    return [builder(recs, lanes) for recs in per_shard_records]


def shard_batches(cfg: aggstate.EngineCfg, mesh, batch_fns, records,
                  host_ids) -> list:
    """Route host-side records to shards (``host_id % n``) and build one
    batch a shard: the host-side L1 role, pure numpy."""
    dest = M.shard_of_host(np.asarray(host_ids), mesh.n)
    return stack_prerouted(batch_fns, [records[dest == s]
                                       for s in range(mesh.n)])


def put_sharded(mesh, batches: list) -> list:
    """Per-shard host batches → tensors on each shard's device."""
    return ShardLayout(mesh).put(batches)


# ------------------------------------------------------------------ folds
def fold_step_sharded(cfg, states: list, cbs: list, rbs: list) -> list:
    """Every shard's conn fold and flat resp pass (the staged-digest
    hot path; flush the digest stage before reading quantiles)."""
    return [step.ingest_resp_flat(cfg, step.ingest_conn(cfg, st, cb), rb)
            for st, cb, rb in zip(states, cbs, rbs)]


def fold_step_dep_sharded(cfg, mesh, states: list, deps: list, cbs: list,
                          rbs: list, tick, cap_per_dest: int):
    """The sharded slab dispatch: every shard's engine fold and direct
    edges, the one-sided halves routed to their flow-owner shard by the
    capacity-bucketed ``all_to_all`` and paired there, and the global
    digest-stage pressure → (states, deps, pressure), the pressure a
    0-d tensor on the first shard's device, not read back."""
    states = fold_step_sharded(cfg, states, cbs, rbs)
    deps = dg.dep_step_fn(mesh, cap_per_dest)(deps, cbs, tick)
    return states, deps, td_pressure_sharded(states)


def td_flush_sharded(cfg, states: list) -> list:
    """Every shard's partial digest-stage flush (its ``td_flush_m``
    fullest stages)."""
    return [step.td_flush_partial(cfg, st) for st in states]


def td_pressure_sharded(states: list):
    """Global max staged-sample count across shards (0-d tensor)."""
    return M.pmax([step.stage_pressure(st) for st in states])


def tick_5s_sharded(cfg, states: list) -> list:
    return [step.tick_5s(cfg, st) for st in states]


def ingest_listener_sharded(cfg, states: list, lbs: list) -> list:
    return [step.ingest_listener(cfg, st, b) for st, b in zip(states, lbs)]


def ingest_host_sharded(cfg, states: list, hbs: list) -> list:
    return [step.ingest_host(cfg, st, b) for st, b in zip(states, hbs)]


def ingest_cpumem_sharded(cfg, states: list, cms: list) -> list:
    return [step.ingest_cpumem(cfg, st, b) for st, b in zip(states, cms)]


def ingest_trace_sharded(cfg, states: list, tbs: list) -> list:
    return [step.ingest_trace(cfg, st, b) for st, b in zip(states, tbs)]


def ingest_task_sharded(cfg, states: list, tbs: list) -> list:
    return [step.ingest_task(cfg, st, b) for st, b in zip(states, tbs)]


def ping_tasks_sharded(cfg, states: list, pbs: list) -> list:
    return [step.ping_tasks(cfg, st, b) for st, b in zip(states, pbs)]


def ingest_delta_sharded(cfg, states: list, deps: list, dbs: list, tick):
    """Every shard folds the delta lanes of its hosts into its state and
    dep slice: pre-aggregated dep edges are direct edges (both
    endpoints known at the agent), so no pairing collective runs."""
    out = [step.ingest_delta(cfg, st, d, b, tick)
           for st, d, b in zip(states, deps, dbs)]
    return [o[0] for o in out], [o[1] for o in out]


def classify_sharded(cfg, states: list) -> list:
    """Every shard classifies its own services and hosts."""
    return [derive.classify_pass(cfg, st) for st in states]


def age_tasks_sharded(cfg, states: list, max_age_ticks: int) -> list:
    return [step.age_tasks(cfg, st, max_age_ticks) for st in states]


def age_apis_sharded(cfg, states: list, max_age_ticks: int) -> list:
    return [step.age_apis(cfg, st, max_age_ticks) for st in states]


# ------------------------------------------------------------ numpy bridge
def state_to_numpy(states: list) -> list:
    """Per-shard states → the reference's stacked ``(n, ...)`` leaves in
    its flattened order and dtypes (a checkpoint's ``leaf_{i}``)."""
    return stack_leaves([aggstate.state_to_numpy(st) for st in states])


def state_from_numpy(stacked, mesh) -> list:
    """Inverse of :func:`state_to_numpy` onto ``mesh``'s devices."""
    return [aggstate.state_from_numpy(leaves, d) for leaves, d in
            zip(unstack_leaves(stacked, mesh.n), mesh.devices)]


def dep_to_numpy(deps: list) -> list:
    """Per-shard dependency graphs → the reference's stacked leaves."""
    return stack_leaves([dg.dep_to_numpy(d) for d in deps])


def dep_from_numpy(stacked, mesh) -> list:
    """Inverse of :func:`dep_to_numpy` onto ``mesh``'s devices."""
    return [dg.dep_from_numpy(leaves, d) for leaves, d in
            zip(unstack_leaves(stacked, mesh.n), mesh.devices)]


def clone(states: list) -> list:
    """Device copies of per-shard NamedTuple trees (snapshot publish)."""
    return [tree_map(torch.clone, st) for st in states]
