"""Process sets and the rest of the collective API against the JAX
package's ``spmd_ops``, bit for bit.

One process per rank over gloo (``spawn_ranks``) at world 2 and 4.  The
ranks register process sets (world 2: ``[1]``; world 4: ``[0, 3]`` and
``[1, 2, 3]``) and run every op of the collective API in the world set
and in each set they belong to, on integer and dyadic inputs (exact in
fp32 whatever the order of a sum).  The JAX side runs the same ops
under ``shard_map`` on a mesh of the set's virtual CPU devices, so a
set's op is held against the op on that sub-mesh.  ``alltoall`` with
even chunks is held against ``spmd_ops.alltoall``, with uneven splits
against numpy.  A rank outside a set must get ``ProcessSetError``.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import spmd_ops
from horovod_tpu.ops.reduce_ops import ReduceOp as JReduceOp
import horovod_tpu_torch as hvd

from test_torch_collectives import spawn_ranks

HELPERS = r"""
import numpy as np

SETS = {2: [[1]], 4: [[0, 3], [1, 2, 3]]}


def inputs(rank):
    # rank's integer, dyadic and (12, 3) dyadic inputs (the workers and
    # the JAX side draw the same ones)
    rs = np.random.RandomState(300 + rank)
    ints = rs.randint(-1000, 1000, (5, 6)).astype(np.int32)
    dyadic = (rs.randint(-2 ** 10, 2 ** 10, (8, 3)) / 64.0).astype(
        np.float32)
    big = (rs.randint(-2 ** 10, 2 ** 10, (12, 3)) / 64.0).astype(np.float32)
    return ints, dyadic, big


def uneven_splits(rank, n):
    return [(rank + j) % 3 for j in range(n)]
"""
exec(HELPERS)


WORKER = HELPERS + r"""
import sys
import torch
import horovod_tpu_torch as hvd

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
ints, dyadic, big = (torch.from_numpy(x) for x in inputs(rank))
res = {}
sets = [hvd.add_process_set(r) for r in SETS[world]]
try:
    hvd.add_process_set(list(range(world)))  # the world's ranks again
except hvd.ProcessSetError:
    res["dup_rejected"] = np.array(1)
for k, ps in enumerate([None] + sets):
    members = list(range(world)) if ps is None else ps.ranks
    if rank not in members:
        try:
            hvd.allreduce(dyadic, process_set=ps)
        except hvd.ProcessSetError:
            res[f"s{k}/outsider_rejected"] = np.array(1)
        continue
    pre = f"s{k}/"
    n = len(members)
    for name, op in (("sum", hvd.Sum), ("average", hvd.Average),
                     ("min", hvd.Min), ("max", hvd.Max)):
        got = hvd.allreduce({"i": ints, "d": dyadic}, op=op, process_set=ps)
        res[pre + name + "_int"] = got["i"].numpy()
        res[pre + name + "_dyadic"] = got["d"].numpy()
    res[pre + "scaled"] = hvd.allreduce(
        dyadic, op=hvd.Sum, prescale_factor=0.5, postscale_factor=4.0,
        process_set=ps).numpy()
    h = hvd.grouped_allreduce_async([dyadic, dyadic * 2], op=hvd.Sum,
                                    process_set=ps)
    g = hvd.synchronize(h)
    res[pre + "grouped_sum0"], res[pre + "grouped_sum1"] = \
        g[0].numpy(), g[1].numpy()
    res[pre + "allgather"] = hvd.synchronize(
        hvd.allgather_async(dyadic, process_set=ps)).numpy()
    ga = hvd.grouped_allgather([ints, dyadic, torch.full((rank + 1, 2),
                                                         rank)],
                               process_set=ps)
    res[pre + "gallgather_int"] = ga[0].numpy()
    res[pre + "gallgather_dyadic"] = ga[1].numpy()
    res[pre + "gallgather_ragged"] = ga[2].numpy()
    res[pre + "broadcast"] = hvd.synchronize(hvd.broadcast_async(
        dyadic, root_rank=members[-1], process_set=ps)).numpy()
    recv, splits = hvd.alltoall(big, process_set=ps)
    res[pre + "alltoall"] = recv.numpy()
    res[pre + "alltoall_splits"] = splits.numpy()
    sp = uneven_splits(rank, n)
    rows = torch.arange(sum(sp) * 2, dtype=torch.float32).view(-1, 2) \
        + 1000 * rank
    recv, splits = hvd.synchronize(hvd.alltoall_async(rows, splits=sp,
                                                      process_set=ps))
    res[pre + "alltoall_uneven"] = recv.numpy()
    res[pre + "alltoall_uneven_splits"] = splits.numpy()
    res[pre + "reducescatter"] = hvd.synchronize(hvd.reducescatter_async(
        big, op=hvd.Sum, process_set=ps)).numpy()
    res[pre + "reducescatter_avg"] = hvd.reducescatter(
        big, op=hvd.Average, process_set=ps).numpy()
    grs = hvd.synchronize(hvd.grouped_reducescatter_async(
        [big, big * 2], op=hvd.Sum, process_set=ps))
    res[pre + "greducescatter0"], res[pre + "greducescatter1"] = \
        grs[0].numpy(), grs[1].numpy()
    res[pre + "greducescatter_sync0"] = hvd.grouped_reducescatter(
        [big], op=hvd.Sum, process_set=ps)[0].numpy()
    hvd.barrier(process_set=ps)
try:
    hvd.join()
except NotImplementedError:
    res["join_raises"] = np.array(1)
hvd.remove_process_set(sets[0])
res["ids"] = np.array(hvd.process_set_ids())
hvd.barrier()
np.savez(out, **res)
hvd.shutdown()
"""


def _spmd_on(ranks, fn, per_rank):
    """``fn`` per rank under shard_map on the virtual devices ``ranks``;
    ``per_rank`` holds every world rank's input.  Returns {rank:
    output}."""
    mesh = Mesh(np.array([jax.devices()[r] for r in ranks]), ("hvd",))
    stacked = jnp.stack([jnp.asarray(per_rank[r]) for r in ranks])

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("hvd"),),
             out_specs=P("hvd"), check_vma=False)
    def body(x):
        return fn(x[0])[None]

    out = np.asarray(body(stacked))
    return {r: out[i] for i, r in enumerate(ranks)}


def _want(members, world):
    """Every op's expected output per member rank, from spmd_ops on the
    set's sub-mesh (uneven alltoall: numpy)."""
    ints = [inputs(r)[0] for r in range(world)]
    dyadic = [inputs(r)[1] for r in range(world)]
    big = [inputs(r)[2] for r in range(world)]
    want = {}
    for name, op in (("sum", JReduceOp.SUM), ("average", JReduceOp.AVERAGE),
                     ("min", JReduceOp.MIN), ("max", JReduceOp.MAX)):
        red = partial(spmd_ops.allreduce, op=op, axis="hvd")
        want[name + "_int"] = _spmd_on(members, red, ints)
        want[name + "_dyadic"] = _spmd_on(members, red, dyadic)
    want["scaled"] = _spmd_on(members, partial(
        spmd_ops.allreduce, op=JReduceOp.SUM, axis="hvd",
        prescale_factor=0.5, postscale_factor=4.0), dyadic)
    want["grouped_sum0"] = want["sum_dyadic"]
    want["grouped_sum1"] = _spmd_on(members, lambda x: spmd_ops.allreduce(
        x * 2, op=JReduceOp.SUM, axis="hvd"), dyadic)
    gather = partial(spmd_ops.allgather, axis="hvd")
    want["allgather"] = _spmd_on(members, gather, dyadic)
    want["gallgather_int"] = _spmd_on(members, gather, ints)
    want["gallgather_dyadic"] = want["allgather"]
    want["broadcast"] = _spmd_on(members, lambda x: spmd_ops.broadcast(
        x, len(members) - 1, axis="hvd"), dyadic)
    want["alltoall"] = _spmd_on(members, partial(spmd_ops.alltoall,
                                                 axis="hvd"), big)
    for key, op in (("reducescatter", JReduceOp.SUM),
                    ("reducescatter_avg", JReduceOp.AVERAGE)):
        want[key] = _spmd_on(members, partial(
            spmd_ops.reducescatter, op=op, axis="hvd"), big)
    want["greducescatter0"] = want["reducescatter"]
    want["greducescatter_sync0"] = want["reducescatter"]
    want["greducescatter1"] = _spmd_on(members, lambda x: spmd_ops.
                                       reducescatter(x * 2, axis="hvd"), big)
    n = len(members)
    sends = {}
    for i, r in enumerate(members):
        sp = uneven_splits(r, n)
        rows = np.arange(sum(sp) * 2, dtype=np.float32).reshape(-1, 2) \
            + 1000 * r
        sends[r] = np.split(rows, np.cumsum(sp)[:-1])
    want["alltoall_uneven"] = {
        r: np.concatenate([sends[s][j] for s in members])
        for j, r in enumerate(members)}
    want["alltoall_uneven_splits"] = {
        r: np.array([uneven_splits(s, n)[j] for s in members], np.int32)
        for j, r in enumerate(members)}
    want["alltoall_splits"] = {r: np.full(n, 12 // n, np.int32)
                               for r in members}
    want["gallgather_ragged"] = {r: np.concatenate(
        [np.full((s + 1, 2), s) for s in members]) for r in members}
    return want


@pytest.mark.parametrize("world", [2, 4])
def test_process_set_collectives_bit_equal_to_spmd_ops(world, tmp_path):
    got = spawn_ranks(WORKER, world, tmp_path)
    all_sets = [list(range(world))] + SETS[world]
    for k, members in enumerate(all_sets):
        want = _want(members, world)
        for r in range(world):
            if r not in members:
                assert int(got[r][f"s{k}/outsider_rejected"]) == 1
                assert not any(key.startswith(f"s{k}/") and "outsider"
                               not in key for key in got[r])
                continue
            for key, per_rank in want.items():
                a, b = got[r][f"s{k}/{key}"], per_rank[r]
                assert a.dtype == b.dtype and a.shape == b.shape, \
                    (k, key, r, a.dtype, b.dtype, a.shape, b.shape)
                np.testing.assert_array_equal(a, b,
                                              err_msg=f"set {k} {key} "
                                                      f"rank {r}")
    for r in range(world):
        assert int(got[r]["dup_rejected"]) == 1
        assert int(got[r]["join_raises"]) == 1
        # the first added set was removed; its id is not reused
        assert list(got[r]["ids"]) == [0] + list(range(2, len(SETS[world])
                                                       + 1))


def test_world_one_process_sets_and_join(monkeypatch):
    """In one process: the world set, the registry's refusals, join()."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    hvd.init(device="cpu")
    try:
        assert hvd.global_process_set.process_set_id == 0
        assert hvd.global_process_set.ranks == [0]
        assert hvd.process_set_ids() == [0]
        assert hvd.join() == 0
        with pytest.raises(hvd.ProcessSetError, match="already exists"):
            hvd.add_process_set([0])
        with pytest.raises(hvd.ProcessSetError, match="out of range"):
            hvd.add_process_set([3])
        with pytest.raises(hvd.ProcessSetError, match="global"):
            hvd.remove_process_set(hvd.global_process_set)
        with pytest.raises(hvd.ProcessSetError, match="not attached"):
            hvd.allreduce(torch.ones(2), process_set=hvd.ProcessSet([0]))
        x = torch.tensor([[1.5, -2.0]])
        recv, splits = hvd.alltoall(x)
        assert torch.equal(recv, x) and splits.tolist() == [1]
        assert torch.equal(hvd.grouped_reducescatter([x])[0], x)
    finally:
        hvd.shutdown()
    assert hvd.global_process_set.process_set_id is None
