"""The port's two-level collectives against the JAX package's.

* Slice detection (``common/topology.py``): the ``HVD_TPU_SLICE_SIZE``
  override and its divide check, one slice per host from the launcher's
  placement, one slice by default; the routing knobs in ``Config`` and
  the launcher's flag reaching them.
* ``DcnCompression`` / ``dcn_compression_from_name``: the wire bits,
  the residual and the spellings equal the JAX package's.
* ``comm_model.modeled_collective_bytes`` equals the JAX function over a
  grid of shapes, worlds, slice sizes, dtypes and wires.
* World 4 (2 slices of 2) and 8 (2 x 4, then 4 x 2 after a re-init), one
  process per rank over gloo: the routed allreduce of dyadic fp32 (pad
  path included) is bit-equal to JAX's ``spmd_ops.hierarchical_allreduce``
  on a ``(dcn, ici)`` mesh of as many CPU devices, to the port's flat
  allreduce and to the numpy sum, on every rank; Average with scale
  factors to 1e-6; a bf16 wire within 2^-7 of max |sum| and bit-equal
  to JAX's (the same casts and association); int leaves exact;
  error feedback halves the stateless error; Min refused; the landing
  reduce-scatter and its inverse bit-exact, compressed to 2^-6; the
  routing gates; the tier counters book the model's bytes, and the
  calls recorded where the primitives issue them are the ones gloo
  issues, with the model's bytes wherever those calls are the model's
  (elsewhere gloo's stand-in all-reduce and the cross padding add to
  them, by exactly their own bytes).  The flag and the wire are read
  at ``init``: each setting is a fresh init.
"""

import argparse

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import compression as jcomp
from horovod_tpu.common.topology import DCN_AXIS as JDCN, ICI_AXIS as JICI
from horovod_tpu.ops import comm_model as jcm
from horovod_tpu.ops import spmd_ops
from horovod_tpu.ops.reduce_ops import ReduceOp as JReduceOp
import horovod_tpu_torch as hvd
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch.common import topology
from horovod_tpu_torch.ops import comm_model as tcm
from horovod_tpu_torch.runner import config_parser
from horovod_tpu_torch.utils.env_parser import Config

from test_torch_collectives import spawn_ranks

HELPERS = r"""
import numpy as np


def dyadic(shape, seed, scale=8):
    rs = np.random.RandomState(seed)
    return (rs.randint(-4 * scale, 4 * scale + 1, shape) / scale).astype(
        np.float32)


def randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def ints(shape, seed):
    return np.random.RandomState(seed).randint(-9, 9, shape).astype(np.int32)


#: a value bf16 cannot hold: stateless compression loses the same
#: epsilon every step
EF_VALUE = float(np.float32(1 / 3) + 2.0 ** -12)
EF_STEPS = 4
"""
exec(HELPERS)

# -- topology ------------------------------------------------------------


def test_override_groups_consecutive_ranks(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SLICE_SIZE", "4")
    assert topology.resolve_slice_ids(8, 8) == [0, 0, 0, 0, 1, 1, 1, 1]
    monkeypatch.setenv("HVD_TPU_SLICE_SIZE", "2")
    ids = topology.resolve_slice_ids(8, 8)
    assert ids == [0, 0, 1, 1, 2, 2, 3, 3]
    assert topology.slice_groups(ids) == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_override_must_divide(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SLICE_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide"):
        topology.resolve_slice_ids(8, 8)


def test_one_slice_by_default(monkeypatch):
    monkeypatch.delenv("HVD_TPU_SLICE_SIZE", raising=False)
    ids = topology.resolve_slice_ids(8, 8)
    assert ids == [0] * 8
    assert topology.slice_groups(ids) is None


def test_one_slice_per_host_from_the_placement(monkeypatch):
    monkeypatch.delenv("HVD_TPU_SLICE_SIZE", raising=False)
    # two hosts of four ranks: the launcher numbers ranks host by host
    assert topology.resolve_slice_ids(8, 4) == [0, 0, 0, 0, 1, 1, 1, 1]
    # a placement that is not homogeneous forms no tier
    assert topology.resolve_slice_ids(6, 4) == [0] * 6
    # the override wins over the placement
    monkeypatch.setenv("HVD_TPU_SLICE_SIZE", "2")
    assert topology.resolve_slice_ids(8, 4) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_unequal_slices_form_no_groups():
    assert topology.slice_groups([0, 0, 1]) is None
    assert topology.slice_groups([0, 1, 1, 2, 2, 0]) == [[0, 5], [1, 2],
                                                         [3, 4]]


def test_world_one_has_no_cross_tier(monkeypatch):
    monkeypatch.delenv("HVD_TPU_SLICE_SIZE", raising=False)
    hvd.init(device="cpu")
    try:
        assert topology.slice_ids() == [0]
        assert topology.num_slices() == 1 and topology.slice_size() == 1
        assert topology.process_slice_groups() is None
        assert topology.tiers() is None
        assert hvd.hierarchical_mesh().tolist() == [[0]]
        assert hvd.hierarchical_mesh(1).tolist() == [[0]]
        with pytest.raises(ValueError, match="equal groups"):
            hvd.hierarchical_mesh(2)
        assert (hvd.WORLD_AXIS, hvd.DCN_AXIS, hvd.ICI_AXIS) == \
            ("hvd", "dcn", "ici")
        from horovod_tpu_torch.ops import collective_ops

        assert not collective_ops.routes_hierarchical(hvd.Sum)
    finally:
        hvd.shutdown()


def test_config_knobs_and_the_launcher_flag(monkeypatch):
    for k in ("HVD_TPU_HIERARCHICAL_ALLREDUCE",
              "HOROVOD_HIERARCHICAL_ALLREDUCE", "HVD_TPU_DCN_WIRE_DTYPE",
              "HOROVOD_DCN_WIRE_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config.from_env()
    assert cfg.hierarchical_allreduce is False and cfg.dcn_wire_dtype == ""
    # the launcher's knob reaches the workers' Config
    env = config_parser.config_to_env(
        argparse.Namespace(hierarchical_allreduce=True))
    assert env == {"HVD_TPU_HIERARCHICAL_ALLREDUCE": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HOROVOD_DCN_WIRE_DTYPE", "BF16")
    cfg = Config.from_env()
    assert cfg.hierarchical_allreduce is True and cfg.dcn_wire_dtype == "bf16"
    env = config_parser.config_to_env(
        argparse.Namespace(), {"hierarchical_allreduce": False})
    monkeypatch.setenv(*next(iter(env.items())))
    assert Config.from_env().hierarchical_allreduce is False


# -- DcnCompression ------------------------------------------------------


def _bits(t):
    """A torch tensor's values as float32 numpy (bf16/fp16 exactly)."""
    return t.float().numpy()


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_compress_shard_matches_jax(wire):
    x = np.concatenate([randn((200,), 3) * 1e3, [1e9, -1e9, 0.0]]).astype(
        np.float32)
    got, res = tcomp.DcnCompression(wire).compress_shard(torch.from_numpy(x))
    want, jres = jcomp.DcnCompression(wire).compress_shard(jnp.asarray(x))
    assert str(got.dtype) == "torch." + wire and res is None and jres is None
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(want.astype(jnp.float32)))
    assert np.isfinite(_bits(got)).all()  # fp16's clamp
    back = tcomp.DcnCompression.decompress_shard(got, torch.float32)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), _bits(got))


def test_narrow_and_int_shards_pass_through():
    comp = tcomp.DcnCompression("bfloat16")
    for shard in (torch.tensor([1, 2], dtype=torch.int32),
                  torch.tensor([1.0, 2.0], dtype=torch.bfloat16),
                  torch.tensor([1.0], dtype=torch.float16)):
        wire, res = comp.compress_shard(shard, "kept")
        assert wire is shard and res == "kept"


def test_error_feedback_residual_matches_jax():
    x = randn((128,), 0)
    comp = tcomp.DcnCompression("bfloat16", error_feedback=True)
    jc = jcomp.DcnCompression("bfloat16", error_feedback=True)
    w1, r1 = comp.compress_shard(torch.from_numpy(x))
    jw1, jr1 = jc.compress_shard(jnp.asarray(x), None)
    np.testing.assert_array_equal(r1.numpy(), x - _bits(w1))
    np.testing.assert_array_equal(r1.numpy(), np.asarray(jr1))
    w2, r2 = comp.compress_shard(torch.from_numpy(x), r1)
    jw2, jr2 = jc.compress_shard(jnp.asarray(x), jr1)
    np.testing.assert_array_equal(_bits(w2),
                                  np.asarray(jw2.astype(jnp.float32)))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(jr2))
    # the EF invariant: sum(wire_i) == sum(shard_i) - residual
    np.testing.assert_allclose(
        _bits(w1).astype(np.float64) + _bits(w2) + r2.numpy(),
        2.0 * x.astype(np.float64), rtol=1e-6)


def test_rejects_a_non_float_wire():
    with pytest.raises(ValueError):
        tcomp.DcnCompression("int8")
    with pytest.raises(TypeError):
        tcomp.DcnCompression("not_a_dtype")


@pytest.mark.parametrize("name", [None, "", "none", "off", "0", "false",
                                  "bf16", "BF16", "fp16", "half",
                                  "float16", "bfloat16", " bf16 ", "bf61",
                                  "int8", "float32", "float64"])
def test_from_name_matches_jax(name):
    got = tcomp.dcn_compression_from_name(name)
    want = jcomp.dcn_compression_from_name(name)
    if want is None:
        assert got is None
    else:
        assert str(got.wire_dtype)[6:] == want.wire_dtype.name
        assert got.error_feedback is False


def test_from_name_warns_once_per_spelling(monkeypatch):
    warned = []

    class Log:
        def warning(self, msg, *args):
            warned.append(msg % args)

    monkeypatch.setattr(tcomp, "get_logger", Log)
    tcomp._warned_wire_dtypes.discard("bf62")
    assert tcomp.dcn_compression_from_name("bf62") is None
    assert tcomp.dcn_compression_from_name("bf62") is None
    assert len(warned) == 1 and "'bf62'" in warned[0]
    assert "bf62" in tcomp._warned_wire_dtypes


# -- the byte model ------------------------------------------------------

MODEL_GRID = [
    ((1024,), 8, 8, None, "float32"), ((1024,), 8, 1, None, "float32"),
    ((1024,), 8, 4, None, "float32"), ((1024,), 8, 4, "bf16", "float32"),
    ((1024,), 8, 4, "fp16", "float32"), ((37,), 8, 4, None, "float32"),
    ((37,), 8, 4, "bfloat16", "float32"), ((1024,), 16, 4, "bf16",
                                           "float32"),
    ((3, 5, 7), 4, 2, None, "float32"), ((3, 5, 7), 4, 2, "bf16",
                                         "float32"),
    ((), 4, 2, None, "float32"), ((1024,), 16, 4, "bf16", "int32"),
    ((1024,), 16, 4, "bf16", "float16"), ((1024,), 16, 4, "bf16",
                                          "float64"),
    ((1024,), 8, 4, "bf16", "float8_e4m3fn"), ((4,), 1, 1, None, "float32"),
    ((130,), 4, 2, "bf16", "bfloat16"), ((551,), 12, 3, None, "float32"),
    ((551,), 12, 3, "fp16", "float32"), ((1000,), 6, 2, "bf16", "float32"),
]


@pytest.mark.parametrize("shape,world,n_ici,wire,dtype", MODEL_GRID)
def test_modeled_collective_bytes_matches_jax(shape, world, n_ici, wire,
                                              dtype):
    got = tcm.modeled_collective_bytes(shape, world, n_ici, wire, dtype)
    assert got == jcm.modeled_collective_bytes(shape, world, n_ici, wire,
                                               dtype)
    # a torch dtype names the payload as its name does
    tdt = getattr(torch, dtype)
    assert tcm.modeled_collective_bytes(shape, world, n_ici, wire,
                                        tdt) == got


def test_model_refuses_bad_arguments():
    with pytest.raises(ValueError):
        tcm.modeled_collective_bytes((4,), 8, 3)
    with pytest.raises(ValueError):
        tcm.modeled_collective_bytes((4,), 0, 1)
    with pytest.raises(ValueError, match="unknown dtype"):
        tcm.modeled_collective_bytes((4,), 8, 4, dtype="not_a_dtype")


def test_measured_tier_bytes_attributes_groups():
    recs = [tcm.collective_record("reduce_scatter", 160, (0, 1, 2, 3)),
            tcm.collective_record("all_gather", 40, (0, 4)),
            tcm.collective_record("all_reduce", 100, (4, 5))]
    got = tcm.measured_tier_bytes(recs, [0, 0, 0, 0, 1, 1, 1, 1])
    # the JAX inventory's numbers for the same ops (reduce_scatter of
    # 160 B over 4, all_gather of a 40 B result over a cross pair)
    assert got["ici_bytes"] == 120 + 100 and got["dcn_bytes"] == 20
    assert [o["tier"] for o in got["ops"]] == ["ici", "dcn", "ici"]
    assert tcm.mesh_slice_ids([[0, 1], [2, 3]]) == [0, 0, 1, 1]
    assert tcm.mesh_slice_ids(np.array([[0, 2], [1, 3]])) == [0, 1, 0, 1]


# -- the collectives across processes ------------------------------------

WORKER = HELPERS + r"""
import os
import sys
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import topology
from horovod_tpu_torch.metrics import instruments as I
from horovod_tpu_torch.ops import collective_ops as co
from horovod_tpu_torch.ops import comm_model as cm
from horovod_tpu_torch.ops import hierarchical as H

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
layouts = [int(a) for a in sys.argv[5].split(",")]
torch.set_num_threads(1)
res = {}
T = torch.from_numpy


def start(name, flag, wire=""):
    # a fresh init: the env is read there, and only there
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1" if flag else "0"
    os.environ["HVD_TPU_DCN_WIRE_DTYPE"] = wire
    hvd.init(device="cpu", rank=rank, size=world,
             init_method="file://" + store + name)


def routed(fn):
    # (value, this call's records, its tier counter deltas)
    ici, dcn = I.COLLECTIVE_ICI_BYTES.get(), I.COLLECTIVE_DCN_BYTES.get()
    with co.recording() as rec:
        val = fn()
    return val, rec, (I.COLLECTIVE_ICI_BYTES.get() - ici,
                      I.COLLECTIVE_DCN_BYTES.get() - dcn)


def calls(rec):
    # each recorded call as "op@its group's ranks"
    return np.array([o["op"] + "@" + ",".join(map(str, o["group"]))
                     for o in rec])


def save_bytes(tag, rec, counters):
    m = cm.measured_tier_bytes(rec, topology.slice_ids())
    res[tag + "/measured"] = np.array([m["ici_bytes"], m["dcn_bytes"]])
    res[tag + "/counters"] = np.array(counters)
    res[tag + "/ops"] = np.array([o["op"] + ":" + o["tier"]
                                  for o in m["ops"]])


for k, ss in enumerate(layouts):
    os.environ["HVD_TPU_SLICE_SIZE"] = str(ss)
    pre = f"s{ss}/"
    start(f"{k}on", True)
    if world % ss:  # the override cannot hold: routed calls raise
        x = T(dyadic((8,), rank))
        try:
            hvd.allreduce(x, op=hvd.Sum)
            res[pre + "raised"] = np.array("")
        except ValueError as e:
            res[pre + "raised"] = np.array(str(e))
        hvd.shutdown()
        start(f"{k}off", False)
        res[pre + "flat"] = hvd.allreduce(x, op=hvd.Sum).numpy()
        hvd.shutdown()
        continue
    t = topology.tiers()
    res[pre + "grid"] = np.array(t.grid)
    res[pre + "mesh"] = hvd.hierarchical_mesh()
    for cols in (32, 37):
        x = T(dyadic((cols,), 100 * cols + rank))
        val, rec, cnt = routed(lambda: hvd.allreduce(x, op=hvd.Sum))
        res[pre + f"sum{cols}"] = val.numpy()
        save_bytes(pre + f"sum{cols}", rec, cnt)
        res[pre + f"grads{cols}"] = hvd.allreduce_gradients(
            x, op=hvd.Sum, hierarchical=False).numpy()
    y = T(randn((130,), 700 + rank))
    hvd.shutdown()
    # the cross wire from HVD_TPU_DCN_WIRE_DTYPE
    start(f"{k}bf16", True, "bf16")
    val, rec, cnt = routed(lambda: hvd.allreduce(y, op=hvd.Sum))
    res[pre + "bf16"] = val.numpy()
    save_bytes(pre + "bf16", rec, cnt)
    if world == 4:  # int leaves skip the wire cast
        tree = {"f": T(dyadic((8,), 500 + rank)),
                "i": T(ints((5,), 600 + rank))}
        val, rec, cnt = routed(lambda: hvd.allreduce(tree, op=hvd.Sum))
        res["tree_f"], res["tree_i"] = val["f"].numpy(), val["i"].numpy()
        res["tree_i_dtype"] = np.array(str(val["i"].dtype))
        save_bytes("tree", rec, cnt)
    hvd.shutdown()
    # the flag off: the same calls stay flat
    start(f"{k}off", False)
    for cols in (32, 37):
        x = T(dyadic((cols,), 100 * cols + rank))
        val, rec, cnt = routed(lambda: hvd.allreduce(x, op=hvd.Sum))
        res[pre + f"flat{cols}"] = val.numpy()
        res[pre + f"flat{cols}/counters"] = np.array(cnt)
        res[pre + f"flat{cols}/calls"] = calls(rec)
    if world == 4:
        res["gate_off"] = np.array(co.routes_hierarchical(hvd.Sum))
    hvd.shutdown()
    if world != 4:
        continue
    start(f"{k}more", True)
    t = topology.tiers()
    # Average with scale factors
    x = T(dyadic((24,), 300 + rank))
    res["avg"] = hvd.allreduce(x, op=hvd.Average, prescale_factor=0.5,
                               postscale_factor=4.0).numpy()
    # error feedback through hierarchical_allreduce, against stateless
    comp = {fb: hvd.DcnCompression("bfloat16", error_feedback=fb)
            for fb in (False, True)}
    v = torch.full((16,), EF_VALUE)
    for fb in (False, True):
        acc, r = torch.zeros(16), None
        for _ in range(EF_STEPS):
            if fb:
                s, r = H.hierarchical_allreduce(v, op=hvd.Sum,
                                                dcn_compression=comp[fb],
                                                residual=r)
            else:
                s = H.hierarchical_allreduce(v, op=hvd.Sum,
                                             dcn_compression=comp[fb])
            acc += s
        res[f"ef{int(fb)}"] = acc.numpy()
    # Min / Max are refused by the two-level op, and stay flat when routed
    x = T(dyadic((6,), 800 + rank))
    for op in (hvd.Min, hvd.Max):
        try:
            H.hierarchical_allreduce(x, op=op)
            res[f"refused{int(op)}"] = np.array(False)
        except ValueError:
            res[f"refused{int(op)}"] = np.array(True)
    val, rec, cnt = routed(lambda: hvd.allreduce(x, op=hvd.Min))
    res["min"], res["min_calls"] = val.numpy(), calls(rec)
    # landing: the two-level reduce-scatter and its inverse
    buf = T(dyadic((world * 5,), 900 + rank))
    shard, _ = H.two_level_reduce_scatter_flat(buf, t)
    res["landed"] = shard.numpy()
    res["regathered"] = H.two_level_all_gather_flat(shard, t).numpy()
    z = T(randn((world * 4,), 950 + rank))
    cshard, _ = H.two_level_reduce_scatter_flat(
        z, t, hvd.DcnCompression("bfloat16"))
    res["landed_bf16"] = H.two_level_all_gather_flat(cshard, t).numpy()
    # the gates
    res["gate_on"] = np.array([co.routes_hierarchical(op) for op in
                               (hvd.Sum, hvd.Average, hvd.Min, hvd.Max,
                                hvd.Adasum)])
    sub = hvd.add_process_set([0, 1])
    res["gate_subset"] = np.array(co.routes_hierarchical(hvd.Sum, sub))
    if rank in (0, 1):
        _, rec, _ = routed(lambda: hvd.allreduce(x, op=hvd.Sum,
                                                 process_set=sub))
        res["subset_calls"] = calls(rec)
    b = torch.tensor([rank % 2 == 0, False, True])
    val, rec, _ = routed(lambda: hvd.allreduce(b, op=hvd.Sum))
    res["bool"], res["bool_calls"] = val.numpy(), calls(rec)
    # grouped, async and bucketed forms route too
    a, c = T(dyadic((9,), 1000 + rank)), T(dyadic((17,), 1100 + rank))
    val, rec, _ = routed(lambda: hvd.grouped_allreduce([a, c], op=hvd.Sum))
    res["grouped"] = np.concatenate([v.numpy() for v in val])
    res["grouped_calls"] = calls(rec)
    val, rec, _ = routed(lambda: hvd.synchronize(hvd.allreduce_async(
        a, op=hvd.Sum)))
    res["async"], res["async_calls"] = val.numpy(), calls(rec)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(T(dyadic((2, 3), 1200)))
        lin.bias.zero_()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.0),
                                   op=hvd.Sum)
    def hooked():
        lin(T(dyadic((4, 3), 1300 + rank))).sum().backward()
        opt.synchronize()
        return torch.cat([lin.weight.grad.reshape(-1), lin.bias.grad])
    val, rec, _ = routed(hooked)
    res["hooked"], res["hooked_calls"] = val.numpy(), calls(rec)
    opt.close()
    # a routed call whose groups are gone raises, never goes flat
    keep = topology.tiers
    def broken():
        raise RuntimeError("no two-level groups")
    topology.tiers = broken
    try:
        hvd.allreduce(x, op=hvd.Sum)
        res["broken"] = np.array("")
    except RuntimeError as e:
        res["broken"] = np.array(str(e))
    topology.tiers = keep
    hvd.shutdown()
np.savez(out, **res)
"""


def _mesh(n_dcn, n_ici):
    return Mesh(np.array(jax.devices()[:n_dcn * n_ici]).reshape(
        n_dcn, n_ici), (JDCN, JICI))


def _jax_hier(rows, n_dcn, n_ici, **kw):
    """JAX's hierarchical_allreduce of the ranks' rows (rank r at mesh
    cell (r // n_ici, r % n_ici)); the value every rank gets."""
    fn = jax.jit(jax.shard_map(
        lambda t: spmd_ops.hierarchical_allreduce(t[0], **kw)[None],
        mesh=_mesh(n_dcn, n_ici), in_specs=P((JDCN, JICI)),
        out_specs=P((JDCN, JICI)), check_vma=False))
    return np.asarray(fn(jnp.asarray(np.stack(rows))))


def _same_on_every_rank(got, key):
    for r in got[1:]:
        np.testing.assert_array_equal(r[key], got[0][key])


def _gloo_calls(n, world, n_ici, wire_item=0, item=4, floating=True):
    """The ``torch.distributed`` calls a routed sum of an ``n``-element
    buffer issues over gloo, as ``(op, bytes handed over, group size,
    tier)``: the local reduce-scatter is an all-to-all where the sum is
    rank-ordered (floating, three or more ranks), else gloo's stand-in,
    an all-reduce of the whole buffer; the cross hop is an all-gather of
    the wire shard, an all-to-all and an all-gather of the shard padded
    to a multiple of ``n_dcn`` (rank-ordered), or an all-reduce."""
    n_dcn = world // n_ici
    padded = -(-n // n_ici) * n_ici
    shard = padded // n_ici
    ordered_local = floating and n_ici > 2
    out = [("all_to_all" if ordered_local else "all_reduce", padded * item,
            n_ici, "ici")]
    if wire_item and floating:
        out.append(("all_gather", n_dcn * shard * wire_item, n_dcn, "dcn"))
    elif floating and n_dcn > 2:
        sp = -(-shard // n_dcn) * n_dcn
        out += [("all_to_all", sp * item, n_dcn, "dcn"),
                ("all_gather", sp * item, n_dcn, "dcn")]
    else:
        out.append(("all_reduce", shard * item, n_dcn, "dcn"))
    out.append(("all_gather", padded * item, n_ici, "ici"))
    return out


def _issued_bytes(calls):
    """Per-tier ring-stream bytes of ``_gloo_calls``' list."""
    tot = {"ici": 0, "dcn": 0}
    for op, nbytes, g, tier in calls:
        tot[tier] += tcm.collective_record(op, nbytes, range(g))[
            "stream_bytes"]
    return [tot["ici"], tot["dcn"]]


def _check_bytes(r, tag, model, calls):
    """The recorded calls are those gloo issues; their bytes are the
    model's except where gloo's stand-in all-reduce or the padding of a
    rank-ordered cross sum adds to them; the counters book the model."""
    assert list(r[tag + "/ops"]) == [f"{op}:{tier}"
                                     for op, _, _, tier in calls]
    want = [model["ici_bytes"], model["dcn_bytes"]]
    np.testing.assert_array_equal(r[tag + "/measured"], _issued_bytes(calls))
    np.testing.assert_array_equal(r[tag + "/counters"], want)


def _check_layout(got, world, ss):
    n_ici, n_dcn = ss, world // ss
    pre = f"s{ss}/"
    grid = np.arange(world).reshape(n_dcn, n_ici)
    for r in got:
        np.testing.assert_array_equal(r[pre + "grid"], grid)
        np.testing.assert_array_equal(r[pre + "mesh"], grid)
    for cols in (32, 37):
        rows = [dyadic((cols,), 100 * cols + r) for r in range(world)]
        want = _jax_hier(rows, n_dcn, n_ici, op=JReduceOp.SUM)[0]
        np.testing.assert_array_equal(want, np.sum(rows, axis=0))
        model = tcm.modeled_collective_bytes((cols,), world, n_ici)
        calls = _gloo_calls(cols, world, n_ici)
        for r in got:
            np.testing.assert_array_equal(r[pre + f"sum{cols}"], want)
            np.testing.assert_array_equal(r[pre + f"flat{cols}"], want)
            np.testing.assert_array_equal(r[pre + f"grads{cols}"], want)
            _check_bytes(r, pre + f"sum{cols}", model, calls)
            # a flat call over a world that spans slices is one
            # all-reduce over the world, booked on the cross tier
            assert list(r[pre + f"flat{cols}/calls"]) == [
                "all_reduce@" + ",".join(map(str, range(world)))]
            np.testing.assert_array_equal(
                r[pre + f"flat{cols}/counters"],
                [0, 2 * (world - 1) * cols * 4 // world])
    rows = [randn((130,), 700 + r) for r in range(world)]
    ref = np.sum(np.asarray(rows, np.float64), axis=0)
    want = _jax_hier(rows, n_dcn, n_ici, op=JReduceOp.SUM,
                     dcn_compression=jcomp.DcnCompression("bfloat16"))[0]
    _same_on_every_rank(got, pre + "bf16")
    got_bf16 = got[0][pre + "bf16"]
    # one bf16 rounding of the slice sums, summed at fp32
    assert np.abs(got_bf16 - ref).max() / np.abs(ref).max() < 2 ** -7
    assert np.abs(want - ref).max() / np.abs(ref).max() < 2 ** -7
    # the same casts and, at these layouts, the same association
    np.testing.assert_array_equal(got_bf16, want)
    model = tcm.modeled_collective_bytes((130,), world, n_ici, "bf16")
    assert model["wire_dtype"] == "bfloat16"
    for r in got:
        _check_bytes(r, pre + "bf16", model,
                     _gloo_calls(130, world, n_ici, wire_item=2))


def test_measured_bytes_are_the_model_where_the_calls_are():
    """Where gloo issues the model's calls (a rank-ordered local hop,
    an all-reduce or wire all-gather across two slices) the issued
    bytes are the model's exactly; elsewhere they differ by gloo's
    stand-in (an all-reduce streams twice a reduce-scatter's bytes)
    and by the padding of a rank-ordered cross sum, and by nothing
    else."""
    for n in (32, 37, 130):
        for wire_item, wire in ((0, None), (2, "bf16")):
            # 2 x 4: all-to-all locally, two slices across
            assert _issued_bytes(_gloo_calls(n, 8, 4, wire_item)) == [
                tcm.modeled_collective_bytes((n,), 8, 4, wire)[k]
                for k in ("ici_bytes", "dcn_bytes")]
            # 2 x 2: the local hop is gloo's all-reduce
            m = tcm.modeled_collective_bytes((n,), 4, 2, wire)
            padded = -(-n // 2) * 2
            assert _issued_bytes(_gloo_calls(n, 4, 2, wire_item)) == [
                m["ici_bytes"] + padded * 4 // 2, m["dcn_bytes"]]
    # 4 x 2, fp32: the cross shard (19 of 38) pads to 20
    m = tcm.modeled_collective_bytes((37,), 8, 2)
    assert _issued_bytes(_gloo_calls(37, 8, 2)) == [
        m["ici_bytes"] + 38 * 4 // 2, 2 * 3 * 20 * 4 // 4]
    assert m["dcn_bytes"] == 2 * 3 * 19 * 4 // 4


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_ranks(WORKER, 4, tmp_path_factory.mktemp("hier4"), "2")


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    # 2 x 4, then 4 x 2 after shutdown and init, then an override that
    # does not divide the world
    return spawn_ranks(WORKER, 8, tmp_path_factory.mktemp("hier8"), "4,2,3",
                       timeout=240)


def test_world4_sums_bit_equal_jax_and_flat_with_exact_bytes(world4):
    _check_layout(world4, 4, 2)


def test_world8_two_by_four_and_four_by_two(world8):
    _check_layout(world8, 8, 4)
    _check_layout(world8, 8, 2)  # groups rebuilt by the second init


def test_an_override_that_does_not_divide_raises_when_routed(world8):
    rows = [dyadic((8,), r) for r in range(8)]
    for r in world8:
        assert "does not divide" in str(r["s3/raised"])
        np.testing.assert_array_equal(r["s3/flat"], np.sum(rows, axis=0))


def test_average_with_scale_factors(world4):
    rows = [dyadic((24,), 300 + r) for r in range(4)]
    want = _jax_hier(rows, 2, 2, average=True, prescale_factor=0.5,
                     postscale_factor=4.0)[0]
    for r in world4:
        np.testing.assert_allclose(r["avg"], np.mean(rows, axis=0) * 2.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(r["avg"], want, rtol=1e-6)


def test_int_leaves_skip_the_wire(world4):
    fs = [dyadic((8,), 500 + r) for r in range(4)]
    is_ = [ints((5,), 600 + r) for r in range(4)]
    for r in world4:
        np.testing.assert_array_equal(r["tree_i"], np.sum(is_, axis=0))
        assert str(r["tree_i_dtype"]) == "torch.int32"
        # dyadic floats survive the bf16 wire exactly here
        np.testing.assert_array_equal(r["tree_f"], np.sum(fs, axis=0))
        ops = list(r["tree/ops"])
        # the fused float bucket crosses in bf16, the int bucket at width
        assert ops.count("all_gather:dcn") == 1
        assert ops.count("all_reduce:dcn") == 1
        calls = (_gloo_calls(8, 4, 2, wire_item=2)
                 + _gloo_calls(5, 4, 2, wire_item=2, floating=False))
        np.testing.assert_array_equal(r["tree/measured"],
                                      _issued_bytes(calls))
        want = [sum(tcm.modeled_collective_bytes(
            (n,), 4, 2, "bf16", dt)[k] for n, dt in ((8, "float32"),
                                                    (5, "int32")))
            for k in ("ici_bytes", "dcn_bytes")]
        np.testing.assert_array_equal(r["tree/counters"], want)


def test_error_feedback_halves_the_stateless_error(world4):
    truth = EF_STEPS * 4 * EF_VALUE
    stateless = np.abs(world4[0]["ef0"] - truth).max()
    ef = np.abs(world4[0]["ef1"] - truth).max()
    assert stateless > 0
    assert ef < stateless / 2, (ef, stateless)
    _same_on_every_rank(world4, "ef1")


def test_min_max_refused_by_the_two_level_op_and_flat_when_routed(world4):
    rows = [dyadic((6,), 800 + r) for r in range(4)]
    for r in world4:
        assert bool(r[f"refused{int(hvd.Min)}"])
        assert bool(r[f"refused{int(hvd.Max)}"])
        np.testing.assert_array_equal(r["min"], np.min(rows, axis=0))
        assert list(r["min_calls"]) == ["all_reduce@0,1,2,3"]


def test_landing_matches_flat_chunks_and_inverts(world4):
    bufs = [dyadic((20,), 900 + r) for r in range(4)]
    total = np.sum(bufs, axis=0)
    for k, r in enumerate(world4):
        np.testing.assert_array_equal(r["landed"], total[5 * k:5 * k + 5])
        np.testing.assert_array_equal(r["regathered"], total)
    zs = np.asarray([randn((16,), 950 + r) for r in range(4)], np.float64)
    ref = zs.sum(0)
    for r in world4:
        assert np.abs(r["landed_bf16"] - ref).max() / np.abs(ref).max() \
            < 2 ** -6


def test_landing_matches_jax_bit_for_bit(world4):
    def both(t):
        shard, _ = spmd_ops._two_level_reduce_scatter_flat(t[0], JICI, JDCN)
        back = spmd_ops._two_level_all_gather_flat(shard, JICI, JDCN)
        return shard[None], back[None]

    fn = jax.jit(jax.shard_map(
        both, mesh=_mesh(2, 2), in_specs=P((JDCN, JICI)),
        out_specs=(P((JDCN, JICI)), P((JDCN, JICI))), check_vma=False))
    shards, backs = fn(jnp.asarray(np.stack(
        [dyadic((20,), 900 + r) for r in range(4)])))
    for k, r in enumerate(world4):
        np.testing.assert_array_equal(r["landed"], np.asarray(shards)[k])
        np.testing.assert_array_equal(r["regathered"], np.asarray(backs)[k])


def test_routing_gates(world4):
    for r in world4:
        assert list(r["gate_on"]) == [True, True, False, False, False]
        assert not bool(r["gate_subset"]) and not bool(r["gate_off"])
    for r in world4[:2]:  # a non-world set stays flat
        assert list(r["subset_calls"]) == ["all_reduce@0,1"]
    for r in world4:  # a bool leaf stays flat
        assert list(r["bool_calls"]) == ["all_reduce@0,1,2,3"]
        np.testing.assert_array_equal(r["bool"], [True, False, True])


def test_grouped_async_and_bucketed_forms_route(world4):
    a = np.sum([dyadic((9,), 1000 + r) for r in range(4)], axis=0)
    c = np.sum([dyadic((17,), 1100 + r) for r in range(4)], axis=0)
    xs = [dyadic((4, 3), 1300 + r) for r in range(4)]
    grad_w = sum(np.ones((2, 1)) * x.sum(0)[None] for x in xs)
    for r in world4:
        np.testing.assert_array_equal(r["grouped"], np.concatenate([a, c]))
        np.testing.assert_array_equal(r["async"], a)
        np.testing.assert_array_equal(
            r["hooked"], np.concatenate([grad_w.reshape(-1),
                                         [4.0 * 4, 4.0 * 4]]))
    for k, r in enumerate(world4):
        # one fused bucket: gloo's local all-reduce, the cross hop, the
        # local all-gather, each over this rank's groups
        local = "0,1" if k < 2 else "2,3"
        cross = f"{k % 2},{k % 2 + 2}"
        for key in ("grouped_calls", "async_calls", "hooked_calls"):
            assert list(r[key]) == [f"all_reduce@{local}",
                                    f"all_reduce@{cross}",
                                    f"all_gather@{local}"], (key, r[key])


def test_a_routed_call_without_groups_raises(world4):
    for r in world4:
        assert "no two-level groups" in str(r["broken"])
